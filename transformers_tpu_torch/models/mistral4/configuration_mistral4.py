"""Mistral4 config (port of transformers_tpu/models/mistral4/configuration_mistral4.py;
reference models/mistral4/configuration_mistral4.py): DeepSeek-V3's
multi-head latent attention and experts with a softmax group router, shared
experts that may be absent (``n_shared_experts`` None), and llama-4's
attention temperature (``llama_4_scaling_beta`` over
``original_max_position_embeddings``)."""

from __future__ import annotations

from ..deepseek_v3.configuration_deepseek_v3 import DeepseekV3Config


class Mistral4Config(DeepseekV3Config):
    model_type = "mistral4"

    def __init__(self, vocab_size=131072, hidden_size=4096,
                 intermediate_size=11264, moe_intermediate_size=2048,
                 num_hidden_layers=36, num_attention_heads=32,
                 n_routed_experts=128, n_shared_experts=None,
                 routed_scaling_factor=1.0, kv_lora_rank=256, q_lora_rank=1024,
                 qk_rope_head_dim=64, v_head_dim=128, qk_nope_head_dim=64,
                 n_group=1, topk_group=1, num_experts_per_tok=4,
                 first_k_dense_replace=0, norm_topk_prob=True,
                 rope_interleave=True, llama_4_scaling_beta=0.1,
                 original_max_position_embeddings=32768, **kwargs):
        kwargs.setdefault("num_key_value_heads", num_attention_heads)
        super().__init__(
            vocab_size=vocab_size, hidden_size=hidden_size,
            intermediate_size=intermediate_size,
            moe_intermediate_size=moe_intermediate_size,
            num_hidden_layers=num_hidden_layers,
            num_attention_heads=num_attention_heads,
            n_routed_experts=n_routed_experts,
            n_shared_experts=n_shared_experts,
            routed_scaling_factor=routed_scaling_factor,
            kv_lora_rank=kv_lora_rank, q_lora_rank=q_lora_rank,
            qk_rope_head_dim=qk_rope_head_dim, v_head_dim=v_head_dim,
            qk_nope_head_dim=qk_nope_head_dim, n_group=n_group,
            topk_group=topk_group, num_experts_per_tok=num_experts_per_tok,
            first_k_dense_replace=first_k_dense_replace,
            norm_topk_prob=norm_topk_prob, rope_interleave=rope_interleave,
            **kwargs)
        self.llama_4_scaling_beta = llama_4_scaling_beta
        self.original_max_position_embeddings = original_max_position_embeddings
