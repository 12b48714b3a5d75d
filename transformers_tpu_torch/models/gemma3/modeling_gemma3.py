"""Gemma3 text decoder (port of the text half of
transformers_tpu/models/gemma3/modeling_gemma3.py; reference
src/transformers/models/gemma3/modeling_gemma3.py).

Gemma2's sandwich-norm layer plus a per-head zero-centred RMSNorm on q and k,
and two rope tables chosen per layer type: the global one (``rope_theta``,
with the config's scaling) for full-attention layers, a local one
(``rope_local_base_freq``, no scaling) for sliding layers. No softcap, so
decode takes K2 and K6 on every layer, the sliding ones with their window.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from ...core.module import RMSNorm
from ...ops.rope import _default_inv_freq, compute_cos_sin
from ..gemma2.modeling_gemma2 import Gemma2DecoderLayer
from ..llama.modeling_llama import LlamaAttention, LlamaForCausalLM, LlamaModel
from .configuration_gemma3 import Gemma3TextConfig


class Gemma3Attention(LlamaAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q_norm = RMSNorm(self.head_dim, config.rms_norm_eps, scale_offset=1.0, **kw)
        self.k_norm = RMSNorm(self.head_dim, config.rms_norm_eps, scale_offset=1.0, **kw)


class Gemma3DecoderLayer(Gemma2DecoderLayer):
    attention_cls = Gemma3Attention


class Gemma3TextModel(LlamaModel):
    decoder_layer_cls = Gemma3DecoderLayer
    scale_embeddings = True

    def __init__(self, config: Gemma3TextConfig, *, dtype, param_dtype, device):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        # the local table of the sliding layers (reference Gemma3TextModel:
        # rope_local_base_freq, no scaling), on the model's device as inv_freq is
        local = SimpleNamespace(rope_theta=config.rope_local_base_freq,
                                partial_rotary_factor=1.0)
        self.register_buffer("local_inv_freq", torch.as_tensor(
            _default_inv_freq(local, head_dim=config.head_dim), dtype=torch.float32,
            device=device), persistent=False)

    def compute_rope(self, position_ids):
        global_rope = compute_cos_sin(position_ids, self.inv_freq, self.attention_scaling,
                                      dtype=self.dtype)
        local_rope = compute_cos_sin(position_ids, self.local_inv_freq, 1.0, dtype=self.dtype)
        return {"global": global_rope, "local": local_rope}

    def rope_for_layer(self, rope, layer_idx):
        if self.config.layer_types[layer_idx] == "sliding_attention":
            return rope["local"]
        return rope["global"]


class Gemma3ForCausalLM(LlamaForCausalLM):
    config_class = Gemma3TextConfig
    model_cls = Gemma3TextModel
