"""GLM-4.5 MoE config (port of the config in
transformers_tpu/models/glm4_moe/modeling_glm4_moe.py:22-65; reference
src/transformers/models/glm4_moe/configuration_glm4_moe.py). The defaults
are GLM-4.5-Air's widths: 46 layers, 96 query heads over 8 kv heads at
head_dim 128 with half of it rotated, 128 routed experts of 1408, top 8,
one shared expert, layer 0 dense."""

from __future__ import annotations

from ...configuration_utils import PretrainedConfig


class Glm4MoeConfig(PretrainedConfig):
    model_type = "glm4_moe"

    def __init__(self, vocab_size=151552, hidden_size=4096, intermediate_size=10944,
                 num_hidden_layers=46, num_attention_heads=96, num_key_value_heads=8,
                 partial_rotary_factor=0.5, head_dim=128, hidden_act="silu",
                 max_position_embeddings=131072, initializer_range=0.02,
                 rms_norm_eps=1e-5, use_cache=True, tie_word_embeddings=False,
                 rope_theta=10000.0, rope_scaling=None, attention_bias=False,
                 attention_dropout=0.0, moe_intermediate_size=1408,
                 num_experts_per_tok=8, n_shared_experts=1, n_routed_experts=128,
                 routed_scaling_factor=1.0, n_group=1, topk_group=1,
                 first_k_dense_replace=1, norm_topk_prob=True, use_qk_norm=False,
                 pad_token_id=None, bos_token_id=None, eos_token_id=None, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.partial_rotary_factor = partial_rotary_factor
        self.head_dim = head_dim
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.rms_norm_eps = rms_norm_eps
        self.use_cache = use_cache
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        self.moe_intermediate_size = moe_intermediate_size
        self.num_experts_per_tok = num_experts_per_tok
        self.n_shared_experts = n_shared_experts
        self.n_routed_experts = n_routed_experts
        self.routed_scaling_factor = routed_scaling_factor
        self.n_group = n_group
        self.topk_group = topk_group
        self.first_k_dense_replace = first_k_dense_replace
        self.norm_topk_prob = norm_topk_prob
        self.use_qk_norm = use_qk_norm
        super().__init__(pad_token_id=pad_token_id, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, tie_word_embeddings=tie_word_embeddings,
                         **kwargs)
