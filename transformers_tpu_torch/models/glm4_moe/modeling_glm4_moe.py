"""GLM-4.5 MoE decoder (port of transformers_tpu/models/glm4_moe/modeling_glm4_moe.py;
reference src/transformers/models/glm4_moe/modeling_glm4_moe.py).

The Llama skeleton with partial rotary (``partial_rotary_factor`` 0.5:
the leading half of each head rotated, so a decode step over the static
cache takes the unfused cached attention, as the JAX package's fused-decode
gate sends it; K1 and K6 serve prefill and continuous batching), biases on
q/k/v only (``attention_bias``; o_proj has none), optional per-head q/k
RMSNorms before the rope (``use_qk_norm``), and DeepSeek-V3's MoE block
(sigmoid group router with the e-score bias, shared experts) on the layers
from ``first_k_dense_replace`` on.
"""

from __future__ import annotations

from ...core.module import RMSNorm
from ..deepseek_v3.modeling_deepseek_v3 import DeepseekV3MoE
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_glm4_moe import Glm4MoeConfig


class Glm4MoeAttention(LlamaAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        if config.use_qk_norm:
            kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
            self.q_norm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)
            self.k_norm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)

    def build_projections(self, config, qkv_bias, o_bias, kw):
        super().build_projections(config, config.attention_bias, False, kw)


class Glm4MoeDecoderLayer(LlamaDecoderLayer):
    attention_cls = Glm4MoeAttention

    def make_mlp(self, config, layer_idx: int, **kw):
        if layer_idx >= config.first_k_dense_replace:
            return DeepseekV3MoE(config, **kw)
        return LlamaMLP(config, **kw)


class Glm4MoeModel(LlamaModel):
    decoder_layer_cls = Glm4MoeDecoderLayer


class Glm4MoeForCausalLM(LlamaForCausalLM):
    config_class = Glm4MoeConfig
    model_cls = Glm4MoeModel


class Glm4MoeModelStandalone(LlamaModelStandalone):
    config_class = Glm4MoeConfig
    model_cls = Glm4MoeModel
