"""Qwen3 config (port of transformers_tpu/models/qwen3/configuration_qwen3.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class Qwen3Config(LlamaConfig):
    """Llama's config with Qwen3's defaults (head_dim 128) and the window of
    the layers from ``max_window_layers`` on."""

    model_type = "qwen3"

    def __init__(self, vocab_size=151936, intermediate_size=22016, num_key_value_heads=32,
                 head_dim=128, max_position_embeddings=32768, use_sliding_window=False,
                 sliding_window=4096, max_window_layers=28, layer_types=None,
                 bos_token_id=None, eos_token_id=None, **kwargs):
        self.use_sliding_window = use_sliding_window
        self.sliding_window = sliding_window if use_sliding_window else None
        self.max_window_layers = max_window_layers
        self.layer_types = layer_types
        super().__init__(vocab_size=vocab_size, intermediate_size=intermediate_size,
                         num_key_value_heads=num_key_value_heads, head_dim=head_dim,
                         max_position_embeddings=max_position_embeddings,
                         bos_token_id=bos_token_id, eos_token_id=eos_token_id, **kwargs)
