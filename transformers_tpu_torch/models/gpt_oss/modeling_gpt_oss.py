"""GPT-OSS decoder (port of transformers_tpu/models/gpt_oss/modeling_gpt_oss.py;
reference src/transformers/models/gpt_oss/modeling_gpt_oss.py).

Attention with a learned sink logit per head (``self_attn.sinks``: it joins
each softmax's denominator and its mass is dropped), which no attention
kernel takes: prefill, static decode and continuous batching all attend
through the eager path (``ops/attention.py``), as the JAX package sends
sinks to its XLA path. Alternating sliding and full layers, yarn rope,
biased q/k/v/o. Every layer is a mixture of experts of its own layout: one
stacked parameter per projection, ``gate_up_proj`` ``[E, H, 2I]`` with gate
and up interleaved along the last dim, ``down_proj`` ``[E, I, H]``, each with
a bias, the checkpoint's tensors as they are (no per-expert keys, no
transpose); a clamped swiglu; routed by a biased Linear, top-k then softmax.
As in the JAX package, every expert computes every token and the routing
weights combine them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...core.module import Linear
from ...ops.moe import topk_routing
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_gpt_oss import GptOssConfig


class GptOssAttention(LlamaAttention):
    """Adds the learned sink logits (reference :293 ``self.sinks``)."""

    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        self.sinks = nn.Parameter(torch.empty((self.num_heads,), dtype=param_dtype,
                                              device=device))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.sinks.zero_()

    def extra_attn_kwargs(self) -> dict:
        return {"sinks": self.sinks}


class GptOssExperts(nn.Module):
    """E experts as the checkpoint stacks them (reference :69): every expert
    on every token, ``(up + 1) · gate·σ(1.702·gate)`` with gate clamped above
    at 7 and up to [-7, 7], each projection's bias added before the combine
    (the routing weights zero the experts a token did not pick), the combine
    built in float32 and rounded to the output's type."""

    alpha = 1.702
    limit = 7.0
    # stacked parameters, loaded and saved whole (``core/loading.py``)
    stacked_names = ("gate_up_proj", "down_proj")
    per_expert_checkpoint = False

    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        e, h, i = config.num_local_experts, config.hidden_size, config.intermediate_size
        for name, shape in (("gate_up_proj", (e, h, 2 * i)), ("gate_up_proj_bias", (e, 2 * i)),
                            ("down_proj", (e, i, h)), ("down_proj_bias", (e, h))):
            self.register_parameter(name, nn.Parameter(torch.empty(shape, dtype=param_dtype,
                                                                   device=device)))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        """normal(0, 0.02) for the projections, as the JAX module draws them
        whatever the config's ``initializer_range``; zeros for the biases."""
        p = getattr(self, name)
        if name.endswith("_bias"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor, routing_weights: torch.Tensor,
                routing_idx: torch.Tensor) -> torch.Tensor:
        e = self.gate_up_proj.shape[0]
        x = x.to(self.dtype)
        gate_up = torch.matmul(x, self.gate_up_proj.to(self.dtype))  # [E, T, 2I]
        gate_up = gate_up + self.gate_up_proj_bias.to(self.dtype)[:, None, :]
        gate = gate_up[..., 0::2].clamp(max=self.limit)
        up = gate_up[..., 1::2].clamp(-self.limit, self.limit)
        inner = (up + 1.0) * (gate * torch.sigmoid(gate * self.alpha))
        out = torch.bmm(inner, self.down_proj.to(self.dtype))  # [E, T, H]
        out = out + self.down_proj_bias.to(self.dtype)[:, None, :]
        one_hot = F.one_hot(routing_idx, e).to(torch.float32)  # [T, k, E]
        combine = torch.einsum("tk,tke->te", routing_weights.float(), one_hot)
        return torch.bmm(combine.to(out.dtype)[:, None, :], out.transpose(0, 1))[:, 0]


class GptOssRouter(Linear):
    """A biased Linear to E logits in the checkpoint's ``[E, H]`` layout, then
    top-k of the logits and a softmax over the kept ones (reference :117)."""

    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__(config.hidden_size, config.num_local_experts, True, dtype=dtype,
                         param_dtype=param_dtype, device=device, init_std=0.02)
        self.top_k = config.num_experts_per_tok

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return topk_routing(super().forward(x), self.top_k, renormalize=False,
                            pre_softmax=False)


class GptOssMLP(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.router = GptOssRouter(config, **kw)
        self.experts = GptOssExperts(config, **kw)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        x = hidden.reshape(b * s, h)
        weights, idx = self.router(x)
        return self.experts(x, weights, idx).reshape(b, s, h)


class GptOssDecoderLayer(LlamaDecoderLayer):
    attention_cls = GptOssAttention
    mlp_cls = GptOssMLP


class GptOssModel(LlamaModel):
    decoder_layer_cls = GptOssDecoderLayer


class GptOssForCausalLM(LlamaForCausalLM):
    config_class = GptOssConfig
    model_cls = GptOssModel


class GptOssModelStandalone(LlamaModelStandalone):
    config_class = GptOssConfig
    model_cls = GptOssModel
