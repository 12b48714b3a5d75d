"""Mixtral sparse-MoE decoder (port of transformers_tpu/models/mixtral/modeling_mixtral.py;
reference src/transformers/models/mixtral/modeling_mixtral.py).

Mistral's attention and, under the checkpoint name ``block_sparse_moe``, the
routed experts of ``ops/moe.py`` with the checkpoint's expert names ``w1``
(gate), ``w3`` (up) and ``w2`` (down); the top-k weights are renormalized.
"""

from __future__ import annotations

from ...ops.moe import SparseMoeBlock
from ..llama.modeling_llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaModel
from ..mistral.modeling_mistral import MistralAttention
from .configuration_mixtral import MixtralConfig


class MixtralSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: MixtralConfig, *, dtype, param_dtype, device):
        super().__init__(config, config.num_local_experts, config.intermediate_size, True,
                         names=("w1", "w3", "w2"), dtype=dtype, param_dtype=param_dtype,
                         device=device)


class MixtralDecoderLayer(LlamaDecoderLayer):
    attention_cls = MistralAttention
    mlp_cls = MixtralSparseMoeBlock
    mlp_name = "block_sparse_moe"


class MixtralModel(LlamaModel):
    decoder_layer_cls = MixtralDecoderLayer


class MixtralForCausalLM(LlamaForCausalLM):
    config_class = MixtralConfig
    model_cls = MixtralModel
