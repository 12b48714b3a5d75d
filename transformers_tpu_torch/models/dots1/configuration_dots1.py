"""dots.llm1 config (port of transformers_tpu/models/dots1/configuration_dots1.py;
reference src/transformers/models/dots1/modular_dots1.py). The expert counts
default to None, as the reference's do: a model is built from a config that
names them."""

from __future__ import annotations

from ...configuration_utils import PretrainedConfig


class Dots1Config(PretrainedConfig):
    model_type = "dots1"

    def __init__(
        self,
        vocab_size=152064,
        hidden_size=4608,
        intermediate_size=10944,
        moe_intermediate_size=1408,
        num_hidden_layers=62,
        num_attention_heads=32,
        num_key_value_heads=32,
        n_shared_experts=None,
        n_routed_experts=None,
        n_group=1,
        topk_group=1,
        num_experts_per_tok=None,
        first_k_dense_replace=0,
        norm_topk_prob=False,
        hidden_act="silu",
        max_position_embeddings=2048,
        initializer_range=0.02,
        rms_norm_eps=1e-6,
        use_cache=True,
        tie_word_embeddings=False,
        rope_theta=10000.0,
        rope_scaling=None,
        attention_bias=False,
        attention_dropout=0.0,
        routed_scaling_factor=1.0,
        sliding_window=4096,
        max_window_layers=62,
        layer_types=None,
        head_dim=None,
        **kwargs,
    ):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.moe_intermediate_size = moe_intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads if num_key_value_heads is not None else num_attention_heads
        self.n_shared_experts = n_shared_experts
        self.n_routed_experts = n_routed_experts
        self.n_group = n_group
        self.topk_group = topk_group
        self.num_experts_per_tok = num_experts_per_tok
        self.first_k_dense_replace = first_k_dense_replace
        self.norm_topk_prob = norm_topk_prob
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.rms_norm_eps = rms_norm_eps
        self.use_cache = use_cache
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self.attention_bias = attention_bias
        self.attention_dropout = attention_dropout
        self.routed_scaling_factor = routed_scaling_factor
        self.sliding_window = sliding_window
        self.max_window_layers = max_window_layers
        self.head_dim = head_dim
        if layer_types is None:
            layer_types = [
                "sliding_attention" if sliding_window is not None and i >= max_window_layers
                else "full_attention" for i in range(num_hidden_layers)]
        self.layer_types = layer_types
        super().__init__(tie_word_embeddings=tie_word_embeddings, **kwargs)
