"""HunYuan dense V1 decoder (port of
transformers_tpu/models/hunyuan_v1_dense/modeling_hunyuan_v1_dense.py;
reference src/transformers/models/hunyuan_v1_dense/modular_hunyuan_v1_dense.py).

The Llama skeleton with per-head RMSNorms on q and k after rope
(``self_attn.query_layernorm`` / ``key_layernorm``, through ``post_rope_qk``,
:31-33), and the dynamic-NTK alpha rope (``ops/rope.py``). A norm after
rope keeps static decode off K2, as in the JAX package.
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
from .configuration_hunyuan_v1_dense import HunYuanDenseV1Config


class HunYuanDenseV1Attention(LlamaAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.query_layernorm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)
        self.key_layernorm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)

    def post_rope_qk(self, q, k):
        return self.query_layernorm(q), self.key_layernorm(k)


class HunYuanDenseV1DecoderLayer(LlamaDecoderLayer):
    attention_cls = HunYuanDenseV1Attention


class HunYuanDenseV1Model(LlamaModel):
    decoder_layer_cls = HunYuanDenseV1DecoderLayer


class HunYuanDenseV1ForCausalLM(LlamaForCausalLM):
    config_class = HunYuanDenseV1Config
    model_cls = HunYuanDenseV1Model


class HunYuanDenseV1ModelStandalone(LlamaModelStandalone):
    config_class = HunYuanDenseV1Config
    model_cls = HunYuanDenseV1Model
