"""Qwen2-MoE decoder (port of transformers_tpu/models/qwen2_moe/modeling_qwen2_moe.py;
reference src/transformers/models/qwen2_moe/modeling_qwen2_moe.py).

Qwen2's attention and a sparse block per layer: softmax-then-top-k routing
(renormalized when ``norm_topk_prob``) over stacked experts
(``ops/moe.py``), plus a shared expert scaled by ``sigmoid(shared_expert_gate(x))``.
Layers in ``mlp_only_layers``, or off the ``decoder_sparse_step``, keep a
dense MLP. The decoder layer keeps the skeleton's forward, so static
generate, its captured step and continuous batching run it unchanged.
"""

from __future__ import annotations

import torch

from ...core.module import Linear
from ...ops.moe import SparseMoeBlock
from ..llama.modeling_llama import (
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    LlamaModelStandalone,
)
from ..qwen2.modeling_qwen2 import Qwen2Attention
from .configuration_qwen2_moe import Qwen2MoeConfig


class Qwen2MoeMLP(LlamaMLP):
    """Gated MLP of an explicit width (the shared expert, the dense layers)."""

    def __init__(self, config, intermediate_size: int, *, dtype, param_dtype, device):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device,
                         intermediate_size=intermediate_size)


class Qwen2MoeSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: Qwen2MoeConfig, *, dtype, param_dtype, device):
        super().__init__(config, config.num_experts, config.moe_intermediate_size,
                         config.norm_topk_prob, dtype=dtype, param_dtype=param_dtype,
                         device=device)
        self.shared_expert = Qwen2MoeMLP(config, config.shared_expert_intermediate_size,
                                         dtype=dtype, param_dtype=param_dtype, device=device)
        self.shared_expert_gate = Linear(config.hidden_size, 1, False, dtype=dtype,
                                         param_dtype=param_dtype, device=device,
                                         init_std=config.initializer_range)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        x = hidden.reshape(b * s, h)
        out = self.routed(x)
        out = out + torch.sigmoid(self.shared_expert_gate(x)) * self.shared_expert(x)
        return out.reshape(b, s, h).to(hidden.dtype)


class Qwen2MoeDecoderLayer(LlamaDecoderLayer):
    attention_cls = Qwen2Attention
    sparse_cls = Qwen2MoeSparseMoeBlock

    def make_mlp(self, config, layer_idx: int, **kw):
        sparse = (layer_idx not in config.mlp_only_layers and config.num_experts > 0
                  and (layer_idx + 1) % config.decoder_sparse_step == 0)
        if sparse:
            return self.sparse_cls(config, **kw)
        return Qwen2MoeMLP(config, config.intermediate_size, **kw)


class Qwen2MoeModel(LlamaModel):
    decoder_layer_cls = Qwen2MoeDecoderLayer


class Qwen2MoeForCausalLM(LlamaForCausalLM):
    config_class = Qwen2MoeConfig
    model_cls = Qwen2MoeModel


class Qwen2MoeModelStandalone(LlamaModelStandalone):
    config_class = Qwen2MoeConfig
    model_cls = Qwen2MoeModel
