"""OLMoE config (port of transformers_tpu/models/olmoe/configuration_olmoe.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class OlmoeConfig(LlamaConfig):
    """Llama's config with OLMoE-1B-7B's defaults: ``num_experts`` experts of
    ``intermediate_size``, ``num_experts_per_tok`` per token (the kept
    weights renormalized when ``norm_topk_prob``), q/k/v clipped to
    ``clip_qkv`` when it is set."""

    model_type = "olmoe"

    def __init__(self, vocab_size=50304, hidden_size=2048, intermediate_size=2048,
                 num_hidden_layers=16, num_attention_heads=16, max_position_embeddings=4096,
                 rms_norm_eps=1e-5, pad_token_id=1, bos_token_id=None, eos_token_id=50279,
                 clip_qkv=None, num_experts_per_tok=8, num_experts=64, output_router_logits=False,
                 router_aux_loss_coef=0.01, norm_topk_prob=False, **kwargs):
        self.clip_qkv = clip_qkv
        self.num_experts_per_tok = num_experts_per_tok
        self.num_experts = num_experts
        self.output_router_logits = output_router_logits
        self.router_aux_loss_coef = router_aux_loss_coef
        self.norm_topk_prob = norm_topk_prob
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size, num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         max_position_embeddings=max_position_embeddings,
                         rms_norm_eps=rms_norm_eps, pad_token_id=pad_token_id,
                         bos_token_id=bos_token_id, eos_token_id=eos_token_id, **kwargs)
