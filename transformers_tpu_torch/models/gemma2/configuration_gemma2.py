"""Gemma2 config (port of transformers_tpu/models/gemma2/configuration_gemma2.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class Gemma2Config(LlamaConfig):
    """Llama's config with Gemma-2's defaults, softcaps, query scale and
    sliding and full layers in turn."""

    model_type = "gemma2"

    def __init__(self, vocab_size=256000, hidden_size=2304, intermediate_size=9216,
                 num_hidden_layers=26, num_attention_heads=8, num_key_value_heads=4,
                 head_dim=256, hidden_activation="gelu_pytorch_tanh",
                 max_position_embeddings=8192, pad_token_id=0, eos_token_id=1, bos_token_id=2,
                 tie_word_embeddings=True, query_pre_attn_scalar=256, sliding_window=4096,
                 layer_types=None, final_logit_softcapping=30.0, attn_logit_softcapping=50.0,
                 **kwargs):
        self.hidden_activation = hidden_activation
        self.query_pre_attn_scalar = query_pre_attn_scalar
        self.sliding_window = sliding_window
        # Alternating local/global: even layers slide (reference
        # configuration_gemma2.py layer_types default).
        self.layer_types = layer_types or [
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(num_hidden_layers)
        ]
        self.final_logit_softcapping = final_logit_softcapping
        self.attn_logit_softcapping = attn_logit_softcapping
        kwargs.setdefault("hidden_act", hidden_activation)
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size,
                         num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         num_key_value_heads=num_key_value_heads, head_dim=head_dim,
                         max_position_embeddings=max_position_embeddings,
                         pad_token_id=pad_token_id, eos_token_id=eos_token_id,
                         bos_token_id=bos_token_id, tie_word_embeddings=tie_word_embeddings,
                         **kwargs)
