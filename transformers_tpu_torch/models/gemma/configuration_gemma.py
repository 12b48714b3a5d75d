"""Gemma config (port of transformers_tpu/models/gemma/configuration_gemma.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class GemmaConfig(LlamaConfig):
    """Llama's config with Gemma-7B's defaults: head_dim 256, gelu-tanh,
    tied embeddings."""

    model_type = "gemma"

    def __init__(self, vocab_size=256000, hidden_size=3072, intermediate_size=24576,
                 num_hidden_layers=28, num_attention_heads=16, num_key_value_heads=16,
                 head_dim=256, hidden_act="gelu_pytorch_tanh", hidden_activation=None,
                 max_position_embeddings=8192, pad_token_id=0, eos_token_id=1, bos_token_id=2,
                 tie_word_embeddings=True, **kwargs):
        # Gemma checkpoints carry hidden_activation; hidden_act is legacy
        # (reference configuration_gemma.py docstring).
        self.hidden_activation = hidden_activation or hidden_act
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size,
                         num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         num_key_value_heads=num_key_value_heads, head_dim=head_dim,
                         hidden_act=hidden_act, max_position_embeddings=max_position_embeddings,
                         pad_token_id=pad_token_id, eos_token_id=eos_token_id,
                         bos_token_id=bos_token_id, tie_word_embeddings=tie_word_embeddings,
                         **kwargs)
