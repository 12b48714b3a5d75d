"""Leaf modules of the port: Linear, Embedding, RMSNorm.

Port of the leaf modules in ``transformers_tpu/core/module.py`` as
``nn.Module``s. Parameters are created on the given device, uninitialised;
``reset_parameters(generator)`` fills them from an explicit
``torch.Generator`` (``PreTrainedModel.init_weights`` seeds one). Each module
computes in ``dtype`` whatever its parameters are stored in
(``param_dtype``), as the JAX modules do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    """Dense layer. ``weight`` is torch's ``[out, in]``, the layout hub
    checkpoints store, so loading needs no transpose (the JAX module keeps
    ``[in, out]`` and transposes at load and save)."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True, *,
                 dtype=torch.float32, param_dtype=torch.float32, device=None,
                 init_std: float = 0.02):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty((out_features, in_features), dtype=param_dtype,
                                               device=device))
        self.bias = (nn.Parameter(torch.empty((out_features,), dtype=param_dtype, device=device))
                     if use_bias else None)

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        if name == "weight":
            self.weight.normal_(0.0, self.init_std, generator=generator)
        else:
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Embedding(nn.Module):
    """Token embedding, ``weight`` [num_embeddings, features]."""

    def __init__(self, num_embeddings: int, features: int, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, init_std: float = 0.02):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.features = features
        self.dtype = dtype
        self.init_std = init_std
        self.weight = nn.Parameter(torch.empty((num_embeddings, features), dtype=param_dtype,
                                               device=device))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.weight.normal_(0.0, self.init_std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-decoder logits: x @ E.T"""
        return x.to(self.dtype) @ self.weight.to(self.dtype).T


class RMSNorm(nn.Module):
    """Root-mean-square norm (reference models/llama/modeling_llama.py:53):
    variance and scale in float32, then one cast to the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, *, dtype=torch.float32,
                 param_dtype=torch.float32, device=None, scale_offset: float = 0.0):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.dtype = dtype
        # gemma-style (1 + weight) parameterisation
        self.scale_offset = scale_offset
        self.weight = nn.Parameter(torch.empty((dim,), dtype=param_dtype, device=device))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.weight.fill_(1.0 - self.scale_offset)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        h = h * torch.rsqrt(h.square().mean(dim=-1, keepdim=True) + self.eps)
        h = h * (self.weight.float() + self.scale_offset)
        return h.to(self.dtype)
