"""Cohere2-MoE decoder (port of
transformers_tpu/models/cohere2_moe/modeling_cohere2_moe.py; reference
src/transformers/models/cohere2_moe/modular_cohere2_moe.py).

Cohere2's parallel-residual sliding/NoPE skeleton with routed experts: the
top k of the raw float32 logits, weighted by their softmax or their sigmoid
(renormalized when ``norm_topk_prob``) (:68-77); shared experts added to
the routed output or averaged with it (:84-88); dense prefix layers at
``prefix_dense_intermediate_size``, which keep rope on their full layers
when ``prefix_dense_sliding_window_pattern`` is 1 (``force_rope``,
:93-97); RMSNorms where ``rms_norm_eps`` is set. The experts are the stacked
``Experts`` of ``ops/moe.py`` under the hub's per-expert names
(``mlp.experts.<e>.gate_proj`` / ``up_proj`` / ``down_proj``, what the
reference writes and the JAX package collects into its ``gate_up_proj``,
:141-147); ``convert.params_from_jax`` splits JAX's ``gate_up_proj`` at I.
"""

from __future__ import annotations

import torch

from ...core.module import RMSNorm
from ...ops.moe import SparseMoeBlock, _top_k
from ..cohere.modeling_cohere import CohereDecoderLayer
from ..cohere2.modeling_cohere2 import (
    Cohere2Attention,
    Cohere2ForCausalLM,
    Cohere2Model,
)
from ..llama.modeling_llama import LlamaMLP, LlamaModelStandalone
from .configuration_cohere2_moe import Cohere2MoeConfig


def cohere2_moe_route(logits: torch.Tensor, top_k: int, selection: str, renormalize: bool
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The top k of the float32 ``logits``, then their softmax, or (any other
    ``selection``) their sigmoid, divided by its sum when ``renormalize``.
    Returns (weights [T, k] float32, indices [T, k])."""
    scores, idx = _top_k(logits.float(), top_k)
    if selection == "softmax":
        return torch.softmax(scores, dim=-1), idx
    weights = torch.sigmoid(scores)
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx


class Cohere2MoeSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: Cohere2MoeConfig, *, dtype, param_dtype, device):
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        super().__init__(config, config.num_experts, config.intermediate_size, False, **kw)
        self.shared_experts = None
        if config.num_shared_experts > 0:
            self.shared_experts = LlamaMLP(
                config, intermediate_size=config.intermediate_size * config.num_shared_experts,
                **kw)

    def route(self, x):
        return cohere2_moe_route(self.gate(x), self.top_k, self.config.expert_selection_fn,
                                 self.config.norm_topk_prob)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        x = hidden.reshape(b * s, h)
        out = self.routed(x)
        if self.shared_experts is not None:
            out = out + self.shared_experts(x)
            if self.config.shared_expert_combination_strategy != "sum":
                out = out / 2
        return out.reshape(b, s, h).to(hidden.dtype)


class Cohere2MoeAttention(Cohere2Attention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        force_rope = (config.mlp_layer_types[layer_idx] == "dense"
                      and config.prefix_dense_sliding_window_pattern == 1)
        self.apply_rope = self.sliding_window is not None or force_rope


class Cohere2MoeDecoderLayer(CohereDecoderLayer):
    attention_cls = Cohere2MoeAttention

    @staticmethod
    def make_norm(config, **kw):
        if config.rms_norm_eps is not None:
            return RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)
        return CohereDecoderLayer.make_norm(config, **kw)

    def make_mlp(self, config, layer_idx: int, **kw):
        if config.mlp_layer_types[layer_idx] == "dense":
            return LlamaMLP(config, intermediate_size=config.prefix_dense_intermediate_size, **kw)
        return Cohere2MoeSparseMoeBlock(config, **kw)


class Cohere2MoeModel(Cohere2Model):
    decoder_layer_cls = Cohere2MoeDecoderLayer


class Cohere2MoeForCausalLM(Cohere2ForCausalLM):
    config_class = Cohere2MoeConfig
    model_cls = Cohere2MoeModel


class Cohere2MoeModelStandalone(LlamaModelStandalone):
    config_class = Cohere2MoeConfig
    model_cls = Cohere2MoeModel
