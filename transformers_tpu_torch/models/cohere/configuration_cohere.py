"""Cohere (Command-R) config (port of transformers_tpu/models/cohere/configuration_cohere.py;
reference src/transformers/models/cohere/configuration_cohere.py)."""

from __future__ import annotations

from ...configuration_utils import PretrainedConfig


class CohereConfig(PretrainedConfig):
    """Command-R v01's widths by default: ``logit_scale`` multiplies the
    logits, ``layer_norm_eps`` is the bias-free LayerNorms' epsilon,
    ``use_qk_norm`` adds head-wise q/k LayerNorms; embeddings tied."""

    model_type = "cohere"

    def __init__(self, vocab_size=256000, hidden_size=8192, intermediate_size=22528,
                 logit_scale=0.0625, num_hidden_layers=40, num_attention_heads=64,
                 num_key_value_heads=None, hidden_act="silu", max_position_embeddings=8192,
                 initializer_range=0.02, layer_norm_eps=1e-5, use_cache=True, pad_token_id=0,
                 bos_token_id=5, eos_token_id=255001, tie_word_embeddings=True,
                 rope_theta=10000.0, rope_scaling=None, attention_bias=False,
                 attention_dropout=0.0, use_qk_norm=False, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.logit_scale = logit_scale
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = (num_key_value_heads if num_key_value_heads is not None
                                    else num_attention_heads)
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.layer_norm_eps = layer_norm_eps
        self.use_cache = use_cache
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        self.use_qk_norm = use_qk_norm
        super().__init__(pad_token_id=pad_token_id, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, tie_word_embeddings=tie_word_embeddings,
                         **kwargs)
