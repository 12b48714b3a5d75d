"""ERNIE-4.5 MoE config (port of
transformers_tpu/models/ernie4_5_moe/configuration_ernie4_5_moe.py)."""

from __future__ import annotations

from ..ernie4_5.configuration_ernie4_5 import Ernie4_5Config


class Ernie4_5_MoeConfig(Ernie4_5Config):
    """ERNIE-4.5's config with ERNIE-4.5-21B-A3B's experts by default:
    ``moe_num_experts`` of ``moe_intermediate_size``, ``moe_k`` a token,
    ``moe_num_shared_experts`` shared ones, on the layers that
    ``moe_layer_interval`` / ``moe_layer_start_index`` / ``moe_layer_end_index``
    pick (an end of -1: the last layer); ``moe_norm_min`` floors the sum the
    kept weights are divided by."""

    model_type = "ernie4_5_moe"

    def __init__(self, moe_intermediate_size=1536, moe_k=6, moe_num_experts=64,
                 moe_num_shared_experts=2, moe_layer_start_index=1, moe_layer_end_index=-1,
                 moe_layer_interval=1, moe_norm_min=1e-12, output_router_logits=False,
                 router_aux_loss_coef=0.001, **kwargs):
        super().__init__(**kwargs)
        self.moe_intermediate_size = moe_intermediate_size
        self.moe_k = moe_k
        self.moe_num_experts = moe_num_experts
        self.moe_num_shared_experts = moe_num_shared_experts
        self.moe_layer_start_index = moe_layer_start_index
        self.moe_layer_end_index = (moe_layer_end_index if moe_layer_end_index >= 0
                                    else self.num_hidden_layers - 1)
        self.moe_layer_interval = moe_layer_interval
        self.moe_norm_min = moe_norm_min
        self.output_router_logits = output_router_logits
        self.router_aux_loss_coef = router_aux_loss_coef
