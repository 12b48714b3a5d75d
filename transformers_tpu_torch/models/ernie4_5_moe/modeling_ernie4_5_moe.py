"""ERNIE-4.5 MoE decoder (port of
transformers_tpu/models/ernie4_5_moe/modeling_ernie4_5_moe.py; reference
src/transformers/models/ernie4_5_moe/modular_ernie4_5_moe.py).

ERNIE-4.5's attention and MLP (interleaved rope, the ``use_bias`` switch)
with routed experts on the layers the config's interval, start and end
pick. The router (``mlp.gate.weight`` ``[E, H]``, kept in float32 whatever
the model's type, its logits computed in float32): softmax, the top k picked
by the probabilities plus ``mlp.moe_statics.e_score_correction_bias``
(``[1, E]``), weighted by the unbiased probabilities over ``max(their sum,
moe_norm_min)``. Shared experts, one gated MLP of ``moe_intermediate_size x
moe_num_shared_experts``, add to the output. The routed experts carry no
biases: a ``use_bias`` MoE config is refused (no published ERNIE-4.5 MoE
checkpoint has one).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.module import Linear
from ...ops.moe import SparseMoeBlock, biased_topk_routing
from ..ernie4_5.modeling_ernie4_5 import Ernie4_5DecoderLayer, Ernie4_5MLP, Ernie4_5Model
from ..llama.modeling_llama import LlamaForCausalLM, LlamaModelStandalone
from .configuration_ernie4_5_moe import Ernie4_5_MoeConfig


class Ernie4_5_MoeStatics(nn.Module):
    """``e_score_correction_bias`` [1, E], float32: it shifts the choice only."""

    def __init__(self, num_experts: int, *, device):
        super().__init__()
        self.e_score_correction_bias = nn.Parameter(
            torch.empty((1, num_experts), dtype=torch.float32, device=device),
            requires_grad=False)

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.e_score_correction_bias.zero_()


class Ernie4_5_MoeSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: Ernie4_5_MoeConfig, *, dtype, param_dtype, device):
        if config.use_bias:
            raise NotImplementedError("ERNIE-4.5 MoE with use_bias: the stacked experts carry "
                                      "no biases")
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        super().__init__(config, config.moe_num_experts, config.moe_intermediate_size, False,
                         top_k=config.moe_k, **kw)
        self.gate = Linear(config.hidden_size, config.moe_num_experts, False,
                           dtype=torch.float32, param_dtype=torch.float32, device=device,
                           init_std=config.initializer_range)
        self.moe_statics = Ernie4_5_MoeStatics(config.moe_num_experts, device=device)
        self.shared_experts = None
        if config.moe_num_shared_experts > 0:
            self.shared_experts = Ernie4_5MLP(
                config, intermediate_size=config.moe_intermediate_size
                * config.moe_num_shared_experts, **kw)

    def route(self, x):
        """Softmax of the float32 logits, picked with the bias, weighted
        without it over ``max(sum, moe_norm_min)`` (JAX
        ``modeling_ernie4_5_moe.py:86-92``)."""
        probs = torch.softmax(self.gate(x).float(), dim=-1)
        return biased_topk_routing(probs, self.moe_statics.e_score_correction_bias[0],
                                   self.top_k, self.config.moe_norm_min)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        x = hidden.reshape(b * s, h)
        out = self.routed(x)
        if self.shared_experts is not None:
            out = out + self.shared_experts(x)
        return out.reshape(b, s, h).to(hidden.dtype)


class Ernie4_5_MoeDecoderLayer(Ernie4_5DecoderLayer):
    def make_mlp(self, config, layer_idx: int, **kw):
        if ((layer_idx + 1) % config.moe_layer_interval == 0
                and config.moe_layer_start_index <= layer_idx <= config.moe_layer_end_index):
            return Ernie4_5_MoeSparseMoeBlock(config, **kw)
        return Ernie4_5MLP(config, **kw)


class Ernie4_5_MoeModel(Ernie4_5Model):
    decoder_layer_cls = Ernie4_5_MoeDecoderLayer


class Ernie4_5_MoeForCausalLM(LlamaForCausalLM):
    config_class = Ernie4_5_MoeConfig
    model_cls = Ernie4_5_MoeModel


class Ernie4_5_MoeModelStandalone(LlamaModelStandalone):
    config_class = Ernie4_5_MoeConfig
    model_cls = Ernie4_5_MoeModel
