"""Qwen3-MoE decoder (port of transformers_tpu/models/qwen3_moe/modeling_qwen3_moe.py;
reference src/transformers/models/qwen3_moe/modeling_qwen3_moe.py).

Qwen3's attention (per-head q/k RMSNorm) and the routed experts of
``ops/moe.py`` without a shared expert; dense layers are Qwen2-MoE's MLP.
"""

from __future__ import annotations

from ...ops.moe import SparseMoeBlock
from ..llama.modeling_llama import LlamaForCausalLM, LlamaModel
from ..qwen2_moe.modeling_qwen2_moe import Qwen2MoeDecoderLayer
from ..qwen3.modeling_qwen3 import Qwen3Attention
from .configuration_qwen3_moe import Qwen3MoeConfig


class Qwen3MoeSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: Qwen3MoeConfig, *, dtype, param_dtype, device):
        super().__init__(config, config.num_experts, config.moe_intermediate_size,
                         config.norm_topk_prob, dtype=dtype, param_dtype=param_dtype,
                         device=device)


class Qwen3MoeDecoderLayer(Qwen2MoeDecoderLayer):
    attention_cls = Qwen3Attention
    sparse_cls = Qwen3MoeSparseMoeBlock


class Qwen3MoeModel(LlamaModel):
    decoder_layer_cls = Qwen3MoeDecoderLayer


class Qwen3MoeForCausalLM(LlamaForCausalLM):
    config_class = Qwen3MoeConfig
    model_cls = Qwen3MoeModel
