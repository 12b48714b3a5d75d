"""Qwen2 config (port of transformers_tpu/models/qwen2/configuration_qwen2.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class Qwen2Config(LlamaConfig):
    """Llama's config with Qwen2's defaults, q/k/v biases and the window of
    the layers from ``max_window_layers`` on."""

    model_type = "qwen2"

    def __init__(self, vocab_size=151936, intermediate_size=22016, num_key_value_heads=32,
                 max_position_embeddings=32768, use_sliding_window=False, sliding_window=4096,
                 max_window_layers=28, bos_token_id=None, eos_token_id=None, **kwargs):
        self.use_sliding_window = use_sliding_window
        self.sliding_window = sliding_window if use_sliding_window else None
        self.max_window_layers = max_window_layers
        # Qwen2 uses bias on q/k/v but not on o_proj
        # (reference models/qwen2/modeling_qwen2.py Qwen2Attention).
        self.attention_qkv_bias = True
        self.attention_o_bias = False
        super().__init__(vocab_size=vocab_size, intermediate_size=intermediate_size,
                         num_key_value_heads=num_key_value_heads,
                         max_position_embeddings=max_position_embeddings,
                         bos_token_id=bos_token_id, eos_token_id=eos_token_id, **kwargs)
