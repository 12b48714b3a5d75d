"""GPT-OSS config (port of transformers_tpu/models/gpt_oss/configuration_gpt_oss.py;
reference src/transformers/models/gpt_oss/configuration_gpt_oss.py)."""

from __future__ import annotations

from ..llama.configuration_llama import LlamaConfig


class GptOssConfig(LlamaConfig):
    """Llama's config with gpt-oss-120b's defaults (gpt-oss-20b: 24 layers, 32
    experts): ``num_local_experts`` (alias ``num_experts``) experts of
    ``intermediate_size``, ``num_experts_per_tok`` a token; ``layer_types``
    alternating, sliding first, at ``sliding_window``; yarn rope with
    fractional correction bounds (``truncate`` False); biased attention."""

    model_type = "gpt_oss"
    attribute_map = {"num_experts": "num_local_experts"}

    def __init__(self, num_hidden_layers=36, num_local_experts=128, vocab_size=201088,
                 hidden_size=2880, intermediate_size=2880, head_dim=64, num_attention_heads=64,
                 num_key_value_heads=8, sliding_window=128, rope_theta=150000.0,
                 max_position_embeddings=131072, rms_norm_eps=1e-5, rope_scaling=None,
                 num_experts_per_tok=4, router_aux_loss_coef=0.9, output_router_logits=False,
                 layer_types=None, attention_bias=True, tie_word_embeddings=False,
                 bos_token_id=None, eos_token_id=None, **kwargs):
        self.num_local_experts = num_local_experts
        self.sliding_window = sliding_window
        self.num_experts_per_tok = num_experts_per_tok
        self.router_aux_loss_coef = router_aux_loss_coef
        self.output_router_logits = output_router_logits
        self.layer_types = layer_types or [
            "sliding_attention" if i % 2 == 0 else "full_attention"
            for i in range(num_hidden_layers)]
        rope_scaling = rope_scaling or {
            "rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0, "beta_slow": 1.0,
            "truncate": False, "original_max_position_embeddings": 4096}
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         intermediate_size=intermediate_size, num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         num_key_value_heads=num_key_value_heads, head_dim=head_dim,
                         max_position_embeddings=max_position_embeddings,
                         rms_norm_eps=rms_norm_eps, rope_theta=rope_theta,
                         rope_scaling=rope_scaling, attention_bias=attention_bias,
                         tie_word_embeddings=tie_word_embeddings, bos_token_id=bos_token_id,
                         eos_token_id=eos_token_id, **kwargs)
