"""Gemma2 decoder (port of transformers_tpu/models/gemma2/modeling_gemma2.py;
reference src/transformers/models/gemma2/modeling_gemma2.py).

Gemma's deltas plus:
- sandwich norms: the attention and MLP branches are normed before the
  residual add too (``post_attention_layernorm``,
  ``pre_feedforward_layernorm``, ``post_feedforward_layernorm``),
- attention logit softcapping (tanh) and final logit softcapping,
- the query scale from ``query_pre_attn_scalar``,
- sliding and full attention layers in turn through ``layer_types``.

The softcap keeps decode off K2 and K6, as in the JAX package (their Pallas
counterparts take no softcap): a decode step attends over the cache through
the plain path; prefill takes K1, which softcaps.
"""

from __future__ import annotations

from ..gemma.modeling_gemma import GemmaAttention, GemmaDecoderLayer, GemmaMLP
from ..llama.modeling_llama import LlamaForCausalLM, LlamaModel
from .configuration_gemma2 import Gemma2Config


Gemma2MLP = GemmaMLP
Gemma2Attention = GemmaAttention


class Gemma2DecoderLayer(GemmaDecoderLayer):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.pre_feedforward_layernorm = self.make_norm(config, **kw)
        self.post_feedforward_layernorm = self.make_norm(config, **kw)

    def forward(self, hidden, cos, sin, attn_args, cache, cache_position):
        h = self.self_attn(self.input_layernorm(hidden), cos, sin, attn_args, cache,
                           cache_position)
        hidden = hidden + self.post_attention_layernorm(h)
        h = self.mlp(self.pre_feedforward_layernorm(hidden))
        return hidden + self.post_feedforward_layernorm(h)


class Gemma2Model(LlamaModel):
    decoder_layer_cls = Gemma2DecoderLayer
    scale_embeddings = True


class Gemma2ForCausalLM(LlamaForCausalLM):
    config_class = Gemma2Config
    model_cls = Gemma2Model
