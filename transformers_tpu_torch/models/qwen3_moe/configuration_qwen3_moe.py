"""Qwen3-MoE config (port of transformers_tpu/models/qwen3_moe/configuration_qwen3_moe.py)."""

from __future__ import annotations

from ..qwen3.configuration_qwen3 import Qwen3Config


class Qwen3MoeConfig(Qwen3Config):
    """Qwen3's config with the MoE fields of Qwen3-30B-A3B's family: 128
    experts of ``moe_intermediate_size`` 768, 8 per token, no shared expert;
    the sparse and dense layers chosen as in ``Qwen2MoeConfig``."""

    model_type = "qwen3_moe"

    def __init__(self, hidden_size=2048, intermediate_size=6144, num_hidden_layers=24,
                 num_attention_heads=32, num_key_value_heads=4, decoder_sparse_step=1,
                 moe_intermediate_size=768, num_experts_per_tok=8, num_experts=128,
                 norm_topk_prob=False, output_router_logits=False, router_aux_loss_coef=0.001,
                 mlp_only_layers=None, **kwargs):
        self.decoder_sparse_step = decoder_sparse_step
        self.moe_intermediate_size = moe_intermediate_size
        self.num_experts_per_tok = num_experts_per_tok
        self.num_experts = num_experts
        self.norm_topk_prob = norm_topk_prob
        self.output_router_logits = output_router_logits
        self.router_aux_loss_coef = router_aux_loss_coef
        self.mlp_only_layers = mlp_only_layers or []
        super().__init__(hidden_size=hidden_size, intermediate_size=intermediate_size,
                         num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         num_key_value_heads=num_key_value_heads, **kwargs)
