"""Qwen2-MoE config (port of transformers_tpu/models/qwen2_moe/configuration_qwen2_moe.py)."""

from __future__ import annotations

from ..qwen2.configuration_qwen2 import Qwen2Config


class Qwen2MoeConfig(Qwen2Config):
    """Qwen2's config with Qwen1.5-MoE-A2.7B's defaults: ``num_experts``
    routed experts of ``moe_intermediate_size``, ``num_experts_per_tok`` per
    token (weights renormalized when ``norm_topk_prob``), a shared expert of
    ``shared_expert_intermediate_size``; a layer is sparse when it is not in
    ``mlp_only_layers`` and its number plus one is a multiple of
    ``decoder_sparse_step``, else a dense MLP of ``intermediate_size``."""

    model_type = "qwen2_moe"

    def __init__(self, vocab_size=151936, hidden_size=2048, intermediate_size=5632,
                 num_hidden_layers=24, num_attention_heads=16, num_key_value_heads=16,
                 max_window_layers=28, decoder_sparse_step=1, moe_intermediate_size=1408,
                 shared_expert_intermediate_size=5632, num_experts_per_tok=4, num_experts=60,
                 norm_topk_prob=False, output_router_logits=False, router_aux_loss_coef=0.001,
                 mlp_only_layers=None, **kwargs):
        self.decoder_sparse_step = decoder_sparse_step
        self.moe_intermediate_size = moe_intermediate_size
        self.shared_expert_intermediate_size = shared_expert_intermediate_size
        self.num_experts_per_tok = num_experts_per_tok
        self.num_experts = num_experts
        self.norm_topk_prob = norm_topk_prob
        self.output_router_logits = output_router_logits
        self.router_aux_loss_coef = router_aux_loss_coef
        self.mlp_only_layers = mlp_only_layers or []
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size, num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         num_key_value_heads=num_key_value_heads,
                         max_window_layers=max_window_layers, **kwargs)
