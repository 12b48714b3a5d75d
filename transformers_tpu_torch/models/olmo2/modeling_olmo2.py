"""OLMo-2 decoder (port of transformers_tpu/models/olmo2/modeling_olmo2.py;
reference src/transformers/models/olmo2/modeling_olmo2.py).

The Llama skeleton with RMSNorms over the full width of the q and k
projections, before the head reshape (``self_attn.q_norm`` / ``k_norm``, the
checkpoint's names), and norms on the sublayers' outputs instead of their
inputs: ``x + post_attention_layernorm(attn(x))``, then ``+
post_feedforward_layernorm(mlp(.))``; no input norm. Plain rotate-half rope,
so K2 serves its static decode. OLMoE adds ``clip_qkv`` to this attention.
"""

from __future__ import annotations

from ...core.module import RMSNorm
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_olmo2 import Olmo2Config


class Olmo2Attention(LlamaAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q_norm = RMSNorm(self.num_heads * self.head_dim, config.rms_norm_eps, **kw)
        self.k_norm = RMSNorm(self.num_kv_heads * self.head_dim, config.rms_norm_eps, **kw)

    def project_qkv(self, hidden):
        b, s, _ = hidden.shape
        q, k, v = self.q_proj(hidden), self.k_proj(hidden), self.v_proj(hidden)
        clip = getattr(self.config, "clip_qkv", None)
        if clip is not None:
            q, k, v = q.clamp(-clip, clip), k.clamp(-clip, clip), v.clamp(-clip, clip)
        q, k = self.q_norm(q), self.k_norm(k)
        return (q.reshape(b, s, self.num_heads, self.head_dim),
                k.reshape(b, s, self.num_kv_heads, self.head_dim),
                v.reshape(b, s, self.num_kv_heads, self.head_dim))

    def norm_qk(self, q, k):
        return q, k  # normalized over the full width in project_qkv


class Olmo2DecoderLayer(LlamaDecoderLayer):
    attention_cls = Olmo2Attention

    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        del self.input_layernorm
        self.post_feedforward_layernorm = self.make_norm(config, dtype=dtype,
                                                         param_dtype=param_dtype, device=device)

    def forward(self, hidden, cos, sin, attn_args, cache, cache_position):
        h = self.self_attn(hidden, cos, sin, attn_args, cache, cache_position)
        hidden = hidden + self.post_attention_layernorm(h)
        return hidden + self.post_feedforward_layernorm(self.mlp(hidden))


class Olmo2Model(LlamaModel):
    decoder_layer_cls = Olmo2DecoderLayer


class Olmo2ForCausalLM(LlamaForCausalLM):
    config_class = Olmo2Config
    model_cls = Olmo2Model


class Olmo2ModelStandalone(LlamaModelStandalone):
    config_class = Olmo2Config
    model_cls = Olmo2Model
