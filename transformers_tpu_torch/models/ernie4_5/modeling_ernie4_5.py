"""ERNIE-4.5 decoder (port of transformers_tpu/models/ernie4_5/modeling_ernie4_5.py;
reference src/transformers/models/ernie4_5/modular_ernie4_5.py).

The Llama skeleton with interleaved rope (``rope_fn``, ``compute_rope``:
pairs of adjacent dims, rotated in float32) and one ``use_bias`` switch for
every attention and MLP projection. Interleaved rope keeps static decode off
K2 (as the JAX package's fused-decode gate does): the eager cached
attention serves it, K1 prefill, K6 continuous-batching decode.
"""

from __future__ import annotations

from ...ops.rope import apply_rotary_pos_emb_interleaved, compute_cos_sin_interleaved
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_ernie4_5 import Ernie4_5Config


class Ernie4_5Attention(LlamaAttention):
    rope_fn = staticmethod(apply_rotary_pos_emb_interleaved)

    def build_projections(self, config, qkv_bias, o_bias, kw):
        super().build_projections(config, config.use_bias, config.use_bias, kw)


class Ernie4_5MLP(LlamaMLP):
    def __init__(self, config, *, dtype, param_dtype, device, intermediate_size=None):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device,
                         intermediate_size=intermediate_size, bias=config.use_bias)


class Ernie4_5DecoderLayer(LlamaDecoderLayer):
    attention_cls = Ernie4_5Attention
    mlp_cls = Ernie4_5MLP


class Ernie4_5Model(LlamaModel):
    decoder_layer_cls = Ernie4_5DecoderLayer

    def compute_rope(self, position_ids):
        return compute_cos_sin_interleaved(position_ids, self.inv_freq, self.attention_scaling,
                                           dtype=self.dtype)


class Ernie4_5ForCausalLM(LlamaForCausalLM):
    config_class = Ernie4_5Config
    model_cls = Ernie4_5Model


class Ernie4_5ModelStandalone(LlamaModelStandalone):
    config_class = Ernie4_5Config
    model_cls = Ernie4_5Model
