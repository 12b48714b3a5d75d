"""HunYuan MoE V1 decoder (port of
transformers_tpu/models/hunyuan_v1_moe/modeling_hunyuan_v1_moe.py; reference
src/transformers/models/hunyuan_v1_moe/modeling_hunyuan_v1_moe.py).

HunYuan dense's attention (per-head q/k RMSNorms after rope, the alpha
rope) and, in every layer, routed experts at ``intermediate_size`` plus an
always-on ``shared_mlp`` of the same width (:284-302). The router
``mlp.gate.wg`` computes in float32 on float32 inputs, as the reference's
float32 ``wg`` does (the JAX package's ``Linear`` rounds both to the
model's type first, ROADMAP §C): softmax, top k, renormalized (:49-52).
``num_experts`` and ``moe_topk`` may differ per layer.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.module import Linear
from ...ops.moe import SparseMoeBlock, topk_routing
from ..hunyuan_v1_dense.modeling_hunyuan_v1_dense import (
    HunYuanDenseV1DecoderLayer,
    HunYuanDenseV1Model,
)
from ..llama.modeling_llama import LlamaForCausalLM, LlamaMLP, LlamaModelStandalone
from .configuration_hunyuan_v1_moe import HunYuanMoEV1Config


def _per_layer(value, layer_idx: int) -> int:
    return value if isinstance(value, int) else value[layer_idx]


class HunYuanMoEV1Gate(nn.Module):
    """``wg``: a bias-free float32 Linear from the hidden size to the experts."""

    def __init__(self, config, num_experts: int, *, device):
        super().__init__()
        self.wg = Linear(config.hidden_size, num_experts, False, dtype=torch.float32,
                         param_dtype=torch.float32, device=device,
                         init_std=config.initializer_range)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wg(x.float())


class HunYuanMoEV1Moe(SparseMoeBlock):
    def __init__(self, config: HunYuanMoEV1Config, layer_idx: int, *, dtype, param_dtype,
                 device):
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        num_experts = _per_layer(config.num_experts, layer_idx)
        super().__init__(config, num_experts, config.intermediate_size, True,
                         top_k=_per_layer(config.moe_topk, layer_idx), **kw)
        self.gate = HunYuanMoEV1Gate(config, num_experts, device=device)
        self.shared_mlp = LlamaMLP(config, **kw)

    def route(self, x):
        return topk_routing(self.gate(x), self.top_k, renormalize=True)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        out = self.routed(hidden.reshape(b * s, h)).reshape(b, s, h).to(hidden.dtype)
        return out + self.shared_mlp(hidden)


class HunYuanMoEV1DecoderLayer(HunYuanDenseV1DecoderLayer):
    def make_mlp(self, config, layer_idx: int, **kw):
        return HunYuanMoEV1Moe(config, layer_idx, **kw)


class HunYuanMoEV1Model(HunYuanDenseV1Model):
    decoder_layer_cls = HunYuanMoEV1DecoderLayer


class HunYuanMoEV1ForCausalLM(LlamaForCausalLM):
    config_class = HunYuanMoEV1Config
    model_cls = HunYuanMoEV1Model


class HunYuanMoEV1ModelStandalone(LlamaModelStandalone):
    config_class = HunYuanMoEV1Config
    model_cls = HunYuanMoEV1Model
