"""OLMo-2 config (port of transformers_tpu/models/olmo2/configuration_olmo2.py)."""

from __future__ import annotations

from ...configuration_utils import PretrainedConfig


class Olmo2Config(PretrainedConfig):
    """OLMo-2-1124-7B's widths by default; every field the JAX config has, with
    its default (``num_key_value_heads`` falls back to the query heads)."""

    model_type = "olmo2"

    def __init__(self, vocab_size=50304, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=None,
                 hidden_act="silu", max_position_embeddings=2048, initializer_range=0.02,
                 use_cache=True, pad_token_id=1, bos_token_id=None, eos_token_id=50279,
                 tie_word_embeddings=False, rope_theta=10000.0, rope_scaling=None,
                 attention_bias=False, attention_dropout=0.0, rms_norm_eps=1e-5, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = (num_key_value_heads if num_key_value_heads is not None
                                    else num_attention_heads)
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.use_cache = use_cache
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        self.rms_norm_eps = rms_norm_eps
        super().__init__(pad_token_id=pad_token_id, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, tie_word_embeddings=tie_word_embeddings,
                         **kwargs)
