"""Phi-3.5-MoE config (port of ``PhimoeConfig`` in
transformers_tpu/models/phimoe/modeling_phimoe.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class PhimoeConfig(LlamaConfig):
    """Llama's config with Phi-3.5-MoE-instruct's widths: 16 experts of
    ``intermediate_size`` 6400, 2 per token by the sparsemixer router
    (``router_jitter_noise`` its threshold), LayerNorms of eps
    ``rms_norm_eps``, an ``lm_head`` bias when ``lm_head_bias``.
    ``input_jitter_noise`` is kept and unused, as in the JAX package."""

    model_type = "phimoe"

    def __init__(self, vocab_size=32064, hidden_size=4096, intermediate_size=6400,
                 num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                 max_position_embeddings=131072, rms_norm_eps=1e-5, pad_token_id=None,
                 bos_token_id=1, eos_token_id=2, rope_theta=1e6, sliding_window=None,
                 num_experts_per_tok=2, num_local_experts=16, output_router_logits=False,
                 router_aux_loss_coef=0.001, router_jitter_noise=0.01, input_jitter_noise=0.0,
                 lm_head_bias=False, **kwargs):
        self.sliding_window = sliding_window
        self.num_experts_per_tok = num_experts_per_tok
        self.num_local_experts = num_local_experts
        self.output_router_logits = output_router_logits
        self.router_aux_loss_coef = router_aux_loss_coef
        self.router_jitter_noise = router_jitter_noise
        self.input_jitter_noise = input_jitter_noise
        self.lm_head_bias = lm_head_bias
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size, num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         num_key_value_heads=num_key_value_heads,
                         max_position_embeddings=max_position_embeddings,
                         rms_norm_eps=rms_norm_eps, pad_token_id=pad_token_id,
                         bos_token_id=bos_token_id, eos_token_id=eos_token_id,
                         rope_theta=rope_theta, **kwargs)
