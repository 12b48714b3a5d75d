"""dots.llm1 decoder (port of transformers_tpu/models/dots1/modeling_dots1.py;
reference src/transformers/models/dots1/modular_dots1.py).

Qwen3's attention (per-head q/k RMSNorms before the rope, so a decode step
still takes K2) with DeepSeek-V3's MLPs: dense below
``first_k_dense_replace``, the sigmoid group-routed experts plus shared
experts from there on.
"""

from __future__ import annotations

from ..deepseek_v3.modeling_deepseek_v3 import DeepseekV3DecoderLayer
from ..llama.modeling_llama import LlamaForCausalLM, LlamaModel
from ..qwen3.modeling_qwen3 import Qwen3Attention
from .configuration_dots1 import Dots1Config


class Dots1DecoderLayer(DeepseekV3DecoderLayer):
    attention_cls = Qwen3Attention


class Dots1Model(LlamaModel):
    decoder_layer_cls = Dots1DecoderLayer


class Dots1ForCausalLM(LlamaForCausalLM):
    config_class = Dots1Config
    model_cls = Dots1Model
