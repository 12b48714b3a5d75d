"""Qwen2 decoder (port of transformers_tpu/models/qwen2/modeling_qwen2.py;
reference src/transformers/models/qwen2/modeling_qwen2.py).

The Llama skeleton with biases on q/k/v and none on o (the config's
``attention_qkv_bias`` / ``attention_o_bias``), and a sliding window on the
layers from ``max_window_layers`` on when ``use_sliding_window`` is set.
"""

from __future__ import annotations

from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
)
from .configuration_qwen2 import Qwen2Config


# nothing to add to the skeleton: the names the JAX package exports
Qwen2MLP = LlamaMLP
Qwen2Attention = LlamaAttention
Qwen2DecoderLayer = LlamaDecoderLayer
Qwen2Model = LlamaModel


class Qwen2ForCausalLM(LlamaForCausalLM):
    config_class = Qwen2Config
    model_cls = Qwen2Model
