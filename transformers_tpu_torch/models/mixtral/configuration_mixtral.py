"""Mixtral config (port of transformers_tpu/models/mixtral/configuration_mixtral.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class MixtralConfig(LlamaConfig):
    """Llama's config with Mixtral-8x7B's defaults: ``num_local_experts``
    experts of ``intermediate_size``, ``num_experts_per_tok`` per token, the
    kept weights renormalized; no window unless ``sliding_window`` is set.
    ``router_jitter_noise`` is kept and unused, as in the JAX package."""

    model_type = "mixtral"

    def __init__(self, intermediate_size=14336, num_key_value_heads=8,
                 max_position_embeddings=4096 * 32, rms_norm_eps=1e-5, rope_theta=1e6,
                 sliding_window=None, num_experts_per_tok=2, num_local_experts=8,
                 output_router_logits=False, router_aux_loss_coef=0.001,
                 router_jitter_noise=0.0, **kwargs):
        self.sliding_window = sliding_window
        self.num_experts_per_tok = num_experts_per_tok
        self.num_local_experts = num_local_experts
        self.output_router_logits = output_router_logits
        self.router_aux_loss_coef = router_aux_loss_coef
        self.router_jitter_noise = router_jitter_noise
        super().__init__(intermediate_size=intermediate_size,
                         num_key_value_heads=num_key_value_heads,
                         max_position_embeddings=max_position_embeddings,
                         rms_norm_eps=rms_norm_eps, rope_theta=rope_theta, **kwargs)
