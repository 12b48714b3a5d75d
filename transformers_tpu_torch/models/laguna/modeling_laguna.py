"""Laguna decoder (port of transformers_tpu/models/laguna/modeling_laguna.py;
reference models/laguna/modular_laguna.py).

Sliding and full attention layers (3:1) with a rope table per layer type:
full layers rotate half the head dim at theta 500k (so their decode step
takes the unfused cached path, as the JAX package's fused-decode gate
sends a rope narrower than the head there), sliding layers all of it at
theta 10k (K2, with the window). Per-layer query-head counts, per-head q/k
RMSNorms, and a softplus output gate on the heads (``g_proj`` of the block's
input, in float32, rounded to the output's type) before ``o_proj``. Layer 0
is a dense MLP; the others route their tokens by sigmoid scores plus an
e-score correction bias (optionally tanh-softcapped) over the stacked
experts of ``ops/moe.py``, scaled by ``moe_routed_scaling_factor``, and add
an ungated shared expert.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch import nn

from ...core.module import Linear, RMSNorm
from ...ops.moe import SparseMoeBlock, biased_topk_routing
from ...ops.rope import _default_inv_freq, compute_cos_sin
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaMLP,
    LlamaModel,
    LlamaModelStandalone,
)
from ..qwen2_moe.modeling_qwen2_moe import Qwen2MoeMLP
from .configuration_laguna import LagunaConfig


class LagunaAttention(LlamaAttention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.q_norm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)
        self.k_norm = RMSNorm(self.head_dim, config.rms_norm_eps, **kw)
        # softplus output gate (reference LagunaAttention.forward:337-344)
        self.gate_per_head = config.gating is True or config.gating == "per-head"
        g_dim = self.num_heads if self.gate_per_head else self.num_heads * self.head_dim
        self.g_proj = Linear(config.hidden_size, g_dim, False, init_std=config.initializer_range,
                             **kw)

    def build_projections(self, config, qkv_bias, o_bias, kw):
        per_layer = config.num_attention_heads_per_layer
        if per_layer:
            self.num_heads = per_layer[self.layer_idx]
        super().build_projections(config, qkv_bias, o_bias, kw)

    def project_out(self, out, hidden):
        gate = F.softplus(self.g_proj(hidden).float()).to(out.dtype)
        if self.gate_per_head:
            b, s, _ = out.shape
            out = (out.reshape(b, s, self.num_heads, self.head_dim)
                   * gate[..., None]).reshape(b, s, -1)
        else:
            out = out * gate
        return self.o_proj(out)


class LagunaTopKRouter(nn.Module):
    """Sigmoid routing with an e-score correction bias and an optional tanh
    softcap on the logits (reference LagunaTopKRouter:224-250): the top k of
    the scores plus the float32 bias pick the experts; their weights are the
    unbiased scores there, divided by their sum and rounded to x's dtype."""

    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.top_k = config.num_experts_per_tok
        self.softcap = config.moe_router_logit_softcapping
        self.gate = Linear(config.hidden_size, config.num_experts, False, dtype=dtype,
                           param_dtype=param_dtype, device=device,
                           init_std=config.initializer_range)
        self.e_score_correction_bias = nn.Parameter(
            torch.empty((config.num_experts,), dtype=torch.float32, device=device),
            requires_grad=False)

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.e_score_correction_bias.zero_()

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        logits = self.gate(x).float()
        if self.softcap and self.softcap > 0.0:
            logits = torch.tanh(logits / self.softcap) * self.softcap
        weights, idx = biased_topk_routing(torch.sigmoid(logits), self.e_score_correction_bias,
                                           self.top_k)
        return weights.to(x.dtype), idx


class LagunaSparseMoeBlock(SparseMoeBlock):
    """Routed experts times ``moe_routed_scaling_factor`` plus the shared
    expert, not gated (reference LagunaSparseMoeBlock:253-272)."""

    def __init__(self, config: LagunaConfig, *, dtype, param_dtype, device):
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        super().__init__(config, config.num_experts, config.moe_intermediate_size, False, **kw)
        self.gate = LagunaTopKRouter(config, **kw)
        self.shared_experts = Qwen2MoeMLP(config, config.shared_expert_intermediate_size, **kw)

    def route(self, x):
        return self.gate(x)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        x = hidden.reshape(b * s, h)
        out = self.routed(x) * self.config.moe_routed_scaling_factor + self.shared_experts(x)
        return out.reshape(b, s, h).to(hidden.dtype)


class LagunaDecoderLayer(LlamaDecoderLayer):
    attention_cls = LagunaAttention

    def make_mlp(self, config, layer_idx: int, **kw):
        if config.mlp_layer_types[layer_idx] == "sparse":
            return LagunaSparseMoeBlock(config, **kw)
        return LlamaMLP(config, **kw)


class LagunaModel(LlamaModel):
    decoder_layer_cls = LagunaDecoderLayer

    def __init__(self, config: LagunaConfig, *, dtype, param_dtype, device):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        # one frequency table per layer type, on the model's device as inv_freq is
        self.type_inv_freq = {}
        for layer_type, params in config.rope_parameters.items():
            stub = SimpleNamespace(rope_theta=params["rope_theta"],
                                   partial_rotary_factor=params.get("partial_rotary_factor", 1.0))
            name = f"inv_freq_{layer_type}"
            self.register_buffer(name, torch.as_tensor(
                _default_inv_freq(stub, head_dim=config.head_dim), dtype=torch.float32,
                device=device), persistent=False)
            self.type_inv_freq[layer_type] = name

    def compute_rope(self, position_ids):
        return {t: compute_cos_sin(position_ids, getattr(self, name), 1.0, dtype=self.dtype)
                for t, name in self.type_inv_freq.items()}

    def rope_for_layer(self, rope, layer_idx):
        return rope[self.config.layer_types[layer_idx]]


class LagunaForCausalLM(LlamaForCausalLM):
    config_class = LagunaConfig
    model_cls = LagunaModel


class LagunaModelStandalone(LlamaModelStandalone):
    config_class = LagunaConfig
    model_cls = LagunaModel
