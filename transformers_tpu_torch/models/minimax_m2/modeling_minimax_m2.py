"""MiniMax-M2 decoder (port of transformers_tpu/models/minimax_m2/modeling_minimax_m2.py;
reference src/transformers/models/minimax_m2/modular_minimax_m2.py).

Pre-norm layers with OLMo-2's attention (RMSNorms over the full q/k width
before the head reshape; plain rope, so K2 serves static decode) and, under
Mixtral's checkpoint names (``block_sparse_moe``: router ``gate``, experts
``w1`` / ``w3`` / ``w2``), the stacked experts of ``ops/moe.py`` routed by
sigmoid scores: the top k of the float32 scores plus the block's
``e_score_correction_bias`` pick the experts, and the unbiased scores there,
divided by their sum, weigh them.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.moe import SparseMoeBlock, biased_topk_routing
from ..llama.modeling_llama import (
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaModelStandalone,
)
from ..olmo2.modeling_olmo2 import Olmo2Attention
from .configuration_minimax_m2 import MiniMaxM2Config


class MiniMaxM2SparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: MiniMaxM2Config, *, dtype, param_dtype, device):
        super().__init__(config, config.num_local_experts, config.intermediate_size, False,
                         names=("w1", "w3", "w2"), dtype=dtype, param_dtype=param_dtype,
                         device=device)
        self.e_score_correction_bias = nn.Parameter(
            torch.empty((config.num_local_experts,), dtype=torch.float32, device=device),
            requires_grad=False)

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.e_score_correction_bias.zero_()

    def route(self, x):
        """Sigmoid scores in float32, picked with the bias, weighted without
        it (JAX ``modeling_minimax_m2.py:51-60``)."""
        return biased_topk_routing(torch.sigmoid(self.gate(x).float()),
                                   self.e_score_correction_bias, self.top_k)


class MiniMaxM2DecoderLayer(LlamaDecoderLayer):
    attention_cls = Olmo2Attention
    mlp_cls = MiniMaxM2SparseMoeBlock
    mlp_name = "block_sparse_moe"


class MiniMaxM2Model(LlamaModel):
    decoder_layer_cls = MiniMaxM2DecoderLayer


class MiniMaxM2ForCausalLM(LlamaForCausalLM):
    config_class = MiniMaxM2Config
    model_cls = MiniMaxM2Model


class MiniMaxM2ModelStandalone(LlamaModelStandalone):
    config_class = MiniMaxM2Config
    model_cls = MiniMaxM2Model
