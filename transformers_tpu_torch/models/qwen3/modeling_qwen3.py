"""Qwen3 decoder (port of transformers_tpu/models/qwen3/modeling_qwen3.py;
reference src/transformers/models/qwen3/modeling_qwen3.py).

The Llama skeleton with a per-head RMSNorm on q and k before rope (Qwen3Attention
``q_norm`` / ``k_norm``). The norms run before the fused decode kernel is
called, so a decode step still takes K2.
"""

from __future__ import annotations

from ...core.module import RMSNorm
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
)
from .configuration_qwen3 import Qwen3Config


Qwen3MLP = LlamaMLP


class Qwen3Attention(LlamaAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        # over the head_dim axis of [B, S, H, D]
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q_norm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)
        self.k_norm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)


class Qwen3DecoderLayer(LlamaDecoderLayer):
    attention_cls = Qwen3Attention


class Qwen3Model(LlamaModel):
    decoder_layer_cls = Qwen3DecoderLayer


class Qwen3ForCausalLM(LlamaForCausalLM):
    config_class = Qwen3Config
    model_cls = Qwen3Model
