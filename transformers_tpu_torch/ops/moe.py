"""Mixture-of-experts routing and expert products.

Port of ``transformers_tpu/ops/moe.py`` (reference
src/transformers/integrations/moe.py ``batched_mm_experts_forward`` :112,
``grouped_mm_experts_forward`` :377, ``ExpertsInterface`` :481). Two routes,
picked by name from ``EXPERTS_FUNCTIONS`` (the config's
``experts_implementation``; ``dense`` when unset):

- ``dense`` (``batched_mm``): every expert computes every token and the
  routing weights combine the outputs. E/k times the ideal work, but three
  large products with no gather or scatter, and nothing whose shape depends
  on the routing.
- ``ragged`` (``grouped_mm``): the token copies sorted by expert, and one
  grouped product per projection over the groups (``torch._grouped_mm``,
  the analog of ``jax.lax.ragged_dot``): T·k rows of work.

Both take the expert weights as ``[E, in, out]`` operands and the routing
``(weights [T, k] float32, indices [T, k])``. The port keeps each
projection's experts as one stacked parameter in the hub's per-expert
``[out, in]`` layout (``Experts``), so the operands are transposed views and
no call stacks or copies a weight. Neither route reads anything back to the
host, so a decode step that runs one can be captured as a CUDA graph, and
both give the same bits on every run: the ragged route sizes its groups
with ``searchsorted`` on the card and sums each token's k rows in a fixed
order instead of scattering them with atomics.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core.module import Linear
from .activations import get_activation


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last axis, largest first,
    the lower index first among equal values (a stable sort)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def topk_routing(router_logits: torch.Tensor, top_k: int, *, renormalize: bool = True,
                 pre_softmax: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax then top-k (or top-k then softmax, ``pre_softmax=False``) in
    float32, the kept weights optionally divided by their sum (reference
    models/mixtral/modeling_mixtral.py ``MixtralSparseMoeBlock.forward``).
    Returns (weights [T, k] float32, indices [T, k] int64)."""
    logits = router_logits.float()
    if pre_softmax:
        weights, idx = _top_k(torch.softmax(logits, dim=-1), top_k)
    else:
        top_logits, idx = _top_k(logits, top_k)
        weights = torch.softmax(top_logits, dim=-1)
    if renormalize:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, idx


def dense_experts_forward(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                          w_down: torch.Tensor, routing_weights: torch.Tensor,
                          routing_idx: torch.Tensor, act: Callable) -> torch.Tensor:
    """Every expert on every token, then the combine ``[T, E]`` built from a
    one-hot of the routing (x [T, H]; w_gate, w_up [E, H, I]; w_down
    [E, I, H]). gate and up are one product each over all E·I columns;
    down is a batched product over the experts; the combine rounds the
    weights to the output's type, as the JAX route does."""
    t, h = x.shape
    e, _, i = w_gate.shape
    one_hot = F.one_hot(routing_idx, e).to(torch.float32)  # [T, k, E]
    combine = torch.einsum("tk,tke->te", routing_weights.float(), one_hot)
    # [H, E*I]: a view when the operand is the transposed [E, I, H] parameter
    gate = (x @ w_gate.permute(1, 0, 2).reshape(h, e * i)).view(t, e, i)
    up = (x @ w_up.permute(1, 0, 2).reshape(h, e * i)).view(t, e, i)
    inner = act(gate) * up
    out = torch.bmm(inner.transpose(0, 1), w_down)  # [E, T, H]
    return torch.bmm(combine.to(out.dtype)[:, None, :], out.transpose(0, 1))[:, 0]


def _grouped_mm_takes(x: torch.Tensor) -> bool:
    """Whether ``torch._grouped_mm`` computes in one call without the host.
    On the CPU it takes every type. On the card it runs its CUTLASS kernel
    for bf16 (sm_90); for another type it falls back to a loop over the
    groups that copies the offsets to the host, a sync that a CUDA-graph
    capture refuses, so those types take ``_grouped_mm_padded``."""
    return x.device.type != "cuda" or x.dtype == torch.bfloat16


def _grouped_mm_padded(xs: torch.Tensor, w: torch.Tensor, sorted_expert: torch.Tensor,
                       starts: torch.Tensor, capacity: int) -> torch.Tensor:
    """The grouped product as one product per expert: each group's rows
    copied into its own block of ``capacity`` rows (at most one copy of a
    token per expert, so T rows suffice), a batched product over the E
    blocks, and the rows read back. No host read; E·T rows of work."""
    n = xs.shape[0]
    row = torch.arange(n, device=xs.device) - starts[sorted_expert]
    blocks = xs.new_zeros(w.shape[0], capacity, xs.shape[1])
    blocks[sorted_expert, row] = xs
    return torch.bmm(blocks, w)[sorted_expert, row]


def ragged_experts_forward(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                           w_down: torch.Tensor, routing_weights: torch.Tensor,
                           routing_idx: torch.Tensor, act: Callable) -> torch.Tensor:
    """The T·k token copies sorted by expert (a stable sort, as
    ``jnp.argsort``), each projection one grouped product over the groups,
    then each token's k rows put back in routing order and summed with
    their weights. The group offsets are ``searchsorted`` on the sorted
    expert ids, made on the card. The sum runs over k in a fixed order, in
    float32 from the products and the weights rounded to the output's type,
    and is rounded once (the JAX route adds the weighted rows in the
    output's type, in the scatter's order)."""
    t, h = x.shape
    e = w_gate.shape[0]
    k = routing_idx.shape[1]
    sorted_expert, order = torch.sort(routing_idx.reshape(-1), stable=True)
    xs = x.index_select(0, order // k)
    experts = torch.arange(e, device=x.device)
    if _grouped_mm_takes(x):
        ends = torch.searchsorted(sorted_expert, experts, right=True).to(torch.int32)

        def grouped(a, w):
            return torch._grouped_mm(a, w, offs=ends)
    else:
        starts = torch.searchsorted(sorted_expert, experts)

        def grouped(a, w):
            return _grouped_mm_padded(a, w, sorted_expert, starts, t)

    inner = act(grouped(xs, w_gate)) * grouped(xs, w_up)
    out = grouped(inner, w_down)  # [T*k, H], sorted by expert
    rows = torch.empty_like(out).index_copy_(0, order, out).view(t, k, h)
    weights = routing_weights.to(out.dtype).float()[:, :, None]
    return (rows.float() * weights).sum(dim=1).to(out.dtype)


EXPERTS_FUNCTIONS = {
    "dense": dense_experts_forward,
    "batched_mm": dense_experts_forward,
    "ragged": ragged_experts_forward,
    "grouped_mm": ragged_experts_forward,
}


def get_experts_fn(implementation: Optional[str]) -> Callable:
    key = implementation or "dense"
    if key not in EXPERTS_FUNCTIONS:
        raise KeyError(f"Unknown experts implementation {key!r}; valid: "
                       f"{sorted(EXPERTS_FUNCTIONS)}")
    return EXPERTS_FUNCTIONS[key]


class Experts(nn.Module):
    """E gated-MLP experts as three stacked parameters, in the hub's
    per-expert layout: gate and up ``[E, I, H]``, down ``[E, H, I]``, named
    as the checkpoint names an expert's projections (``gate_proj``,
    ``up_proj``, ``down_proj``; Mixtral's ``w1``, ``w3``, ``w2``). A
    checkpoint holds one tensor per expert, ``<this module>.<e>.<name>.weight``:
    loading copies it into slice e and saving writes the slices back
    (``core/loading.py`` ``expert_slots``)."""

    def __init__(self, num_experts: int, hidden_size: int, intermediate_size: int,
                 hidden_act: str, names=("gate_proj", "up_proj", "down_proj"), *,
                 dtype=torch.float32, param_dtype=torch.float32, device=None,
                 init_std: float = 0.02):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.stacked_names = tuple(names)
        self.act = get_activation(hidden_act)
        e, h, i = num_experts, hidden_size, intermediate_size
        for name, shape in zip(names, ((e, i, h), (e, i, h), (e, h, i))):
            self.register_parameter(name, nn.Parameter(torch.empty(shape, dtype=param_dtype,
                                                                   device=device)))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator,
                       expert: Optional[int] = None) -> None:
        """normal(0, init_std), of every expert or of ``expert`` only."""
        p = getattr(self, name)
        (p if expert is None else p[expert]).normal_(0.0, self.init_std, generator=generator)

    def forward(self, x: torch.Tensor, routing_weights: torch.Tensor, routing_idx: torch.Tensor,
                implementation: Optional[str] = None) -> torch.Tensor:
        gate, up, down = (getattr(self, n).to(self.dtype).transpose(1, 2)
                          for n in self.stacked_names)
        return get_experts_fn(implementation)(x.to(self.dtype), gate, up, down, routing_weights,
                                              routing_idx, self.act)


class SparseMoeBlock(nn.Module):
    """Router (``gate``, a bias-free Linear to E logits) and ``experts``:
    top-k routing in float32, then the route the config's
    ``experts_implementation`` names, read at every call."""

    def __init__(self, config, num_experts: int, intermediate_size: int, renormalize: bool,
                 names=("gate_proj", "up_proj", "down_proj"), *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.top_k = config.num_experts_per_tok
        self.renormalize = renormalize
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.gate = Linear(config.hidden_size, num_experts, False, **kw)
        self.experts = Experts(num_experts, config.hidden_size, intermediate_size,
                               config.hidden_act, names, **kw)

    def routed(self, x: torch.Tensor) -> torch.Tensor:
        """The experts' weighted sum for tokens x [T, H]."""
        weights, idx = topk_routing(self.gate(x), self.top_k, renormalize=self.renormalize)
        return self.experts(x, weights, idx, getattr(self.config, "experts_implementation", None))

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        return self.routed(hidden.reshape(b * s, h)).reshape(b, s, h).to(hidden.dtype)
