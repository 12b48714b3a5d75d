"""Gemma decoder (port of transformers_tpu/models/gemma/modeling_gemma.py;
reference src/transformers/models/gemma/modeling_gemma.py).

The Llama skeleton with three deltas:
- embeddings scaled by sqrt(hidden_size) rounded to the compute dtype
  (GemmaModel.forward ``normalizer``; ``LlamaModel.embed_scale``),
- zero-centred RMSNorm: output * (1 + weight) (GemmaRMSNorm),
- a gelu_pytorch_tanh MLP through the config's ``hidden_activation``.
"""

from __future__ import annotations

from ...core.module import RMSNorm
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_gemma import GemmaConfig


GemmaMLP = LlamaMLP
GemmaAttention = LlamaAttention


class GemmaDecoderLayer(LlamaDecoderLayer):
    @staticmethod
    def make_norm(config, **kw):
        return RMSNorm(config.hidden_size, config.rms_norm_eps, scale_offset=1.0, **kw)


class GemmaModel(LlamaModel):
    decoder_layer_cls = GemmaDecoderLayer
    scale_embeddings = True


class GemmaForCausalLM(LlamaForCausalLM):
    config_class = GemmaConfig
    model_cls = GemmaModel


class GemmaModelStandalone(LlamaModelStandalone):
    config_class = GemmaConfig
    model_cls = GemmaModel
