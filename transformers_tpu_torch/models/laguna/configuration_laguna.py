"""Laguna config (port of transformers_tpu/models/laguna/configuration_laguna.py;
reference models/laguna/modular_laguna.py:50-181)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class LagunaConfig(LlamaConfig):
    """Llama's config with Laguna's defaults: ``layer_types`` (every fourth
    layer full attention, the rest sliding at ``sliding_window``), a rope
    table per layer type (``rope_parameters``: theta 500k over half the head
    dim on full layers, theta 10k over all of it on sliding ones), per-layer
    query-head counts (``num_attention_heads_per_layer``), a softplus output
    gate (``gating``: per head, or per element), and ``mlp_layer_types``
    (layer 0 dense, the rest sparse: ``num_experts`` experts of
    ``moe_intermediate_size``, ``num_experts_per_tok`` a token, scaled by
    ``moe_routed_scaling_factor``, plus a shared expert).
    ``moe_apply_router_weight_on_input`` is kept and unused, as in the JAX
    package."""

    model_type = "laguna"

    def __init__(self, vocab_size=100352, hidden_size=2048, intermediate_size=8192,
                 num_hidden_layers=40, num_attention_heads=48, num_key_value_heads=8,
                 head_dim=128, max_position_embeddings=131072, rms_norm_eps=1e-6,
                 tie_word_embeddings=False, rope_parameters=None, sliding_window=512,
                 layer_types=None, gating=True, num_attention_heads_per_layer=None,
                 mlp_layer_types=None, num_experts=256, num_experts_per_tok=8,
                 moe_intermediate_size=512, shared_expert_intermediate_size=512,
                 moe_routed_scaling_factor=1.0, moe_apply_router_weight_on_input=False,
                 moe_router_logit_softcapping=0.0, output_router_logits=False,
                 router_aux_loss_coef=0.001, bos_token_id=None, eos_token_id=None, **kwargs):
        self.sliding_window = sliding_window
        self.gating = gating
        self.num_attention_heads_per_layer = num_attention_heads_per_layer
        self.num_experts = num_experts
        self.num_experts_per_tok = num_experts_per_tok
        self.moe_intermediate_size = moe_intermediate_size
        self.shared_expert_intermediate_size = shared_expert_intermediate_size
        self.moe_routed_scaling_factor = moe_routed_scaling_factor
        self.moe_apply_router_weight_on_input = moe_apply_router_weight_on_input
        self.moe_router_logit_softcapping = moe_router_logit_softcapping
        self.output_router_logits = output_router_logits
        self.router_aux_loss_coef = router_aux_loss_coef
        # per-layer-type rope tables (reference default_rope_params :140)
        self.rope_parameters = rope_parameters or {
            "full_attention": {"rope_type": "default", "rope_theta": 500000.0,
                               "partial_rotary_factor": 0.5},
            "sliding_attention": {"rope_type": "default", "rope_theta": 10000.0,
                                  "partial_rotary_factor": 1.0},
        }
        self.layer_types = layer_types or [
            "full_attention" if (i + 1) % 4 == 0 else "sliding_attention"
            for i in range(num_hidden_layers)]
        self.mlp_layer_types = mlp_layer_types or ["dense"] + ["sparse"] * (num_hidden_layers - 1)
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size, num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         num_key_value_heads=num_key_value_heads, head_dim=head_dim,
                         max_position_embeddings=max_position_embeddings,
                         rms_norm_eps=rms_norm_eps, tie_word_embeddings=tie_word_embeddings,
                         bos_token_id=bos_token_id, eos_token_id=eos_token_id, **kwargs)
