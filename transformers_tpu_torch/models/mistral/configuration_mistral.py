"""Mistral config (port of transformers_tpu/models/mistral/configuration_mistral.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class MistralConfig(LlamaConfig):
    """Llama's config with Mistral-7B's defaults and a window on every layer."""

    model_type = "mistral"

    def __init__(self, intermediate_size=14336, num_key_value_heads=8,
                 max_position_embeddings=4096 * 32, sliding_window=4096, **kwargs):
        self.sliding_window = sliding_window
        super().__init__(intermediate_size=intermediate_size,
                         num_key_value_heads=num_key_value_heads,
                         max_position_embeddings=max_position_embeddings, **kwargs)
