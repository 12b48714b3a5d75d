"""Cohere2 / Command-R7B decoder (port of transformers_tpu/models/cohere2/modeling_cohere2.py;
reference src/transformers/models/cohere2/modeling_cohere2.py).

Cohere's parallel-residual skeleton with a sliding/full layer pattern: the
sliding layers take interleaved rope and the window, the full layers no
rope at all (``apply_rope`` False, :42). K1 serves every layer's prefill
and K6 its continuous-batching decode, with the window where the layer has
one; static decode runs on the eager cached attention (interleaved rope and
NoPE keep it off K2, as in the JAX package).
"""

from __future__ import annotations

from ..cohere.modeling_cohere import (
    CohereAttention,
    CohereDecoderLayer,
    CohereForCausalLM,
    CohereModel,
)
from ..llama.modeling_llama import LlamaModelStandalone
from .configuration_cohere2 import Cohere2Config


class Cohere2Attention(CohereAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        self.apply_rope = self.sliding_window is not None


class Cohere2DecoderLayer(CohereDecoderLayer):
    attention_cls = Cohere2Attention


class Cohere2Model(CohereModel):
    decoder_layer_cls = Cohere2DecoderLayer


class Cohere2ForCausalLM(CohereForCausalLM):
    config_class = Cohere2Config
    model_cls = Cohere2Model


class Cohere2ModelStandalone(LlamaModelStandalone):
    config_class = Cohere2Config
    model_cls = Cohere2Model
