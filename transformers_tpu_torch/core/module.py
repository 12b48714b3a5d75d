"""Leaf modules of the port: Linear, Embedding, RMSNorm, LayerNorm, HeadwiseLayerNorm, Bias.

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

from ..ops.quantized_linear import code_type, quantized_linear
from ..quantizers.weight_only import dequantize_fp8, dequantize_int8, unpack_int4


class Linear(nn.Module):
    """Dense layer. ``weight`` is torch's ``[out, in]``, the layout hub
    checkpoints store, so loading needs no transpose (the JAX module keeps
    ``[in, out]`` and transposes at load and save).

    Weight-only quantized (``set_quantized``, which ``quantizers.quantize_params``
    calls): ``weight`` holds the codes, not trainable: int8 ``[out, in]``,
    int4 packed two a byte along the input dim ``[out, in / 2]``, or
    ``float8_e4m3fn`` ``[out, in]``; and ``weight_scale`` the float32
    per-output-row scale [out]. The forward then computes ``(x @ codes.T) *
    scale`` in f32 and rounds once to ``dtype`` (the JAX ``quantized_dot``),
    through the port's quantized-product kernels on the card
    (``ops/quantized_linear.py``) and their plain version on the CPU; it
    refuses gradients, as the JAX package has no training route for quantized
    weights."""

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
        self.register_parameter("weight_scale", None)  # set by set_quantized

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        if self.weight_scale is not None:
            raise ValueError("a quantized Linear is not initialised from a seed")
        if name == "weight":
            self.weight.normal_(0.0, self.init_std, generator=generator)
        else:
            self.bias.zero_()

    def set_quantized(self, codes: torch.Tensor, scale: torch.Tensor) -> None:
        """Replace the weight by its codes and per-output-row float32 scale."""
        code_type(codes, self.in_features)  # raises for codes of no known layout
        if codes.shape[0] != self.out_features or scale.shape != (self.out_features,):
            raise ValueError(f"codes {tuple(codes.shape)} and scale {tuple(scale.shape)} do not "
                             f"fit a Linear of {self.in_features} -> {self.out_features}")
        self.weight = nn.Parameter(codes, requires_grad=False)
        self.weight_scale = nn.Parameter(scale.to(torch.float32), requires_grad=False)

    def materialize_weight(self) -> torch.Tensor:
        """The weight ``[out, in]`` in the compute dtype; dequantizes a quantized
        weight (JAX ``Linear.materialize_weight``)."""
        w = self.weight
        if self.weight_scale is None:
            return w.to(self.dtype)
        kind = code_type(w, self.in_features)
        if kind == "fp8":
            return dequantize_fp8(w, self.weight_scale, self.dtype)
        if kind == "int8":
            return dequantize_int8(w, self.weight_scale, self.dtype)
        return unpack_int4(w, self.weight_scale, self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        if self.weight_scale is None:
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)
        # codes stream at their stored width; the scale goes on the product's output
        y = quantized_linear(x.to(self.dtype), self.weight, self.weight_scale,
                             in_features=self.in_features)
        return y if bias is None else y + bias


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


class LayerNorm(nn.Module):
    """Layer norm (JAX ``LayerNorm``, torch-compatible): mean, variance and the
    affine map in float32, then one cast to the compute dtype. ``use_bias``
    False (Cohere's norm) keeps no bias parameter at all."""

    def __init__(self, dim: int, eps: float = 1e-5, *, use_bias: bool = True,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((dim,), dtype=param_dtype, device=device))
        self.bias = (nn.Parameter(torch.empty((dim,), dtype=param_dtype, device=device))
                     if use_bias else None)

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        getattr(self, name).fill_(1.0 if name == "weight" else 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        mean = h.mean(dim=-1, keepdim=True)
        var = (h - mean).square().mean(dim=-1, keepdim=True)
        h = (h - mean) * torch.rsqrt(var + self.eps) * self.weight.float()
        if self.bias is not None:
            h = h + self.bias.float()
        return h.to(self.dtype)


class HeadwiseLayerNorm(nn.Module):
    """Layer norm over the head dim of x [B, S, heads, D] with a ``[heads, D]``
    weight and no bias (Cohere's q/k norm, JAX
    ``models/cohere/modeling_cohere.py:30-50``): float32 inside, the result in
    x's dtype."""

    def __init__(self, num_heads: int, head_dim: int, eps: float = 1e-5, *,
                 dtype=torch.float32, param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty((num_heads, head_dim), dtype=param_dtype,
                                               device=device))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.weight.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.float()
        mean = h.mean(dim=-1, keepdim=True)
        var = (h - mean).square().mean(dim=-1, keepdim=True)
        return ((h - mean) * torch.rsqrt(var + self.eps) * self.weight.float()).to(x.dtype)


class Bias(nn.Module):
    """A bias vector alone: the own bias of a decoder whose weight is the tied
    word-embedding table (DistilBERT's ``vocab_projector``, ModernBERT's
    ``decoder``), which is never stored."""

    def __init__(self, dim: int, *, param_dtype=torch.float32, device=None):
        super().__init__()
        self.bias = nn.Parameter(torch.empty((dim,), dtype=param_dtype, device=device))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.bias.zero_()
