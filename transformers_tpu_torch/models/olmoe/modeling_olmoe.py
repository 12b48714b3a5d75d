"""OLMoE decoder (port of transformers_tpu/models/olmoe/modeling_olmoe.py;
reference src/transformers/models/olmoe/modeling_olmoe.py).

The Llama skeleton with RMSNorms over the full width of the q and k
projections (``hidden`` and ``kvh·D``), applied after ``clip_qkv`` and before
the head reshape, under the checkpoint's names ``self_attn.q_norm`` /
``k_norm`` (the JAX package calls them ``full_q_norm`` / ``full_k_norm``;
``convert.params_from_jax`` maps them). Each layer's feed-forward is the
routed experts of ``ops/moe.py``: softmax then top-k, renormalized when
``norm_topk_prob`` (not for OLMoE-1B-7B).
"""

from __future__ import annotations

from ...core.module import RMSNorm
from ...ops.moe import SparseMoeBlock
from ..llama.modeling_llama import LlamaAttention, LlamaDecoderLayer, LlamaForCausalLM, LlamaModel
from .configuration_olmoe import OlmoeConfig


class OlmoeAttention(LlamaAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q_norm = RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        self.k_norm = RMSNorm(self.num_kv_heads * self.head_dim, config.rms_norm_eps, **kw)

    def project_qkv(self, hidden):
        b, s, _ = hidden.shape
        q, k, v = self.q_proj(hidden), self.k_proj(hidden), self.v_proj(hidden)
        clip = self.config.clip_qkv
        if clip is not None:
            q, k, v = q.clamp(-clip, clip), k.clamp(-clip, clip), v.clamp(-clip, clip)
        q, k = self.q_norm(q), self.k_norm(k)
        return (q.reshape(b, s, self.num_heads, self.head_dim),
                k.reshape(b, s, self.num_kv_heads, self.head_dim),
                v.reshape(b, s, self.num_kv_heads, self.head_dim))

    def norm_qk(self, q, k):
        return q, k  # normalized over the full width in project_qkv


class OlmoeSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: OlmoeConfig, *, dtype, param_dtype, device):
        super().__init__(config, config.num_experts, config.intermediate_size,
                         config.norm_topk_prob, dtype=dtype, param_dtype=param_dtype,
                         device=device)


class OlmoeDecoderLayer(LlamaDecoderLayer):
    attention_cls = OlmoeAttention
    mlp_cls = OlmoeSparseMoeBlock


class OlmoeModel(LlamaModel):
    decoder_layer_cls = OlmoeDecoderLayer


class OlmoeForCausalLM(LlamaForCausalLM):
    config_class = OlmoeConfig
    model_cls = OlmoeModel
