"""Solar-Open config (port of transformers_tpu/models/solar_open/configuration_solar_open.py;
reference src/transformers/models/solar_open/modular_solar_open.py): GLM-4.5's
with full rotary, no q/k norm and experts on every layer."""

from __future__ import annotations

from ..glm4_moe.configuration_glm4_moe import Glm4MoeConfig


class SolarOpenConfig(Glm4MoeConfig):
    model_type = "solar_open"

    def __init__(self, vocab_size=196608, moe_intermediate_size=1280,
                 num_hidden_layers=48, num_attention_heads=64, head_dim=128,
                 num_experts_per_tok=8, rope_theta=1_000_000.0,
                 partial_rotary_factor=1.0, **kwargs):
        # every layer is MoE (the reference removes first_k_dense_replace)
        kwargs.setdefault("first_k_dense_replace", 0)
        kwargs.setdefault("use_qk_norm", False)
        kwargs.setdefault("intermediate_size", moe_intermediate_size)
        super().__init__(vocab_size=vocab_size,
                         moe_intermediate_size=moe_intermediate_size,
                         num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         head_dim=head_dim, num_experts_per_tok=num_experts_per_tok,
                         rope_theta=rope_theta,
                         partial_rotary_factor=partial_rotary_factor, **kwargs)
