"""MiniMax-M2 config (port of
transformers_tpu/models/minimax_m2/configuration_minimax_m2.py; reference
src/transformers/models/minimax_m2/modular_minimax_m2.py)."""

from __future__ import annotations

from ...configuration_utils import PretrainedConfig


class MiniMaxM2Config(PretrainedConfig):
    """MiniMax-M2's published widths by default: 62 layers, 48 query heads over
    8 kv heads at head_dim 128, ``num_local_experts`` (alias ``num_experts``)
    experts of ``intermediate_size``, ``num_experts_per_tok`` a token."""

    model_type = "minimax_m2"
    attribute_map = {"num_experts": "num_local_experts"}

    def __init__(self, vocab_size=200064, hidden_size=3072, intermediate_size=1536,
                 num_hidden_layers=62, num_attention_heads=48, num_key_value_heads=8,
                 head_dim=128, hidden_act="silu", max_position_embeddings=196608,
                 initializer_range=0.02, rms_norm_eps=1e-6, use_cache=True,
                 pad_token_id=None, bos_token_id=200034, eos_token_id=200020,
                 tie_word_embeddings=False, attention_dropout=0.0,
                 num_experts_per_tok=8, num_local_experts=256,
                 rope_theta=5_000_000.0, rope_scaling=None, **kwargs):
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.intermediate_size = intermediate_size
        self.num_hidden_layers = num_hidden_layers
        self.num_attention_heads = num_attention_heads
        self.num_key_value_heads = num_key_value_heads
        self.head_dim = head_dim
        self.hidden_act = hidden_act
        self.max_position_embeddings = max_position_embeddings
        self.initializer_range = initializer_range
        self.rms_norm_eps = rms_norm_eps
        self.use_cache = use_cache
        self.attention_dropout = attention_dropout
        self.num_experts_per_tok = num_experts_per_tok
        self.num_local_experts = num_local_experts
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        super().__init__(pad_token_id=pad_token_id, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, tie_word_embeddings=tie_word_embeddings,
                         **kwargs)
