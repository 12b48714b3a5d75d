"""HunYuan MoE V1 config (port of
transformers_tpu/models/hunyuan_v1_moe/configuration_hunyuan_v1_moe.py)."""

from __future__ import annotations

from ...configuration_utils import PretrainedConfig


class HunYuanMoEV1Config(PretrainedConfig):
    """HunYuan dense's fields plus ``num_experts`` and ``moe_topk``, each an
    int or a list with one entry per layer; the experts and the shared MLP
    are at ``intermediate_size``."""

    model_type = "hunyuan_v1_moe"

    def __init__(self, vocab_size=290943, hidden_size=4096, intermediate_size=11008,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=None,
                 hidden_act="silu", max_position_embeddings=2048, initializer_range=0.02,
                 rms_norm_eps=1e-5, use_cache=True, pad_token_id=0, bos_token_id=1,
                 eos_token_id=2, eod_token_id=3, sep_token_id=4, tie_word_embeddings=False,
                 rope_theta=10000.0, rope_scaling=None, attention_bias=False,
                 attention_dropout=0.0, num_experts=1, moe_topk=1, head_dim=None, **kwargs):
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
        self.rms_norm_eps = rms_norm_eps
        self.use_cache = use_cache
        self.eod_token_id = eod_token_id
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        self.num_experts = num_experts
        self.moe_topk = moe_topk
        self.head_dim = head_dim
        super().__init__(pad_token_id=pad_token_id, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, sep_token_id=sep_token_id,
                         tie_word_embeddings=tie_word_embeddings, **kwargs)
