"""Weight-only int8 / int4 / fp8 quantization.

Port of ``transformers_tpu/quantizers/weight_only.py``: symmetric
per-output-channel int8, int4 packed two nibbles per byte, and fp8 e4m3, each
with one float32 scale per output row. The rules are the JAX package's,
written for torch's ``[out, in]`` weight layout (JAX keeps ``[in, out]``):
the scale runs over the input dim, and int4 packs along the input dim, so
byte ``j`` of row ``n`` holds code ``(n, 2j)`` in its low nibble and
``(n, 2j + 1)`` in its high nibble (the JAX packed tensor, transposed).

``quantized_dot`` is the plain version of the product the port computes on
the card with its own kernels (``ops/quantized_linear.py``): codes widened to
the activations' values, f32 sums, the f32 scale on the product's output and
one rounding to the output type.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .base import QuantizationConfig, Quantizer, register_quantizer


@dataclass
class Int8WeightOnlyConfig(QuantizationConfig):
    quant_method: str = "int8_weight_only"


@dataclass
class Int4WeightOnlyConfig(QuantizationConfig):
    quant_method: str = "int4_weight_only"


@dataclass
class Fp8WeightOnlyConfig(QuantizationConfig):
    quant_method: str = "fp8_weight_only"


def _row_scale(w: torch.Tensor, top: float) -> torch.Tensor:
    return torch.clamp_min(w.abs().amax(dim=1) / top, 1e-8)


@register_quantizer("int8_weight_only")
class Int8WeightOnlyQuantizer(Quantizer):
    def quantize_tensor(self, key, value):
        w = value.float()  # [out, in]
        scale = _row_scale(w, 127.0)
        q = torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8)
        return q, scale


@register_quantizer("int4_weight_only")
class Int4WeightOnlyQuantizer(Quantizer):
    """Symmetric int4, two values packed per int8 along the input dim."""

    def quantize_tensor(self, key, value):
        w = value.float()
        in_dim = w.shape[1]
        if in_dim % 2:
            raise ValueError(f"int4 packing needs even input dim, got {in_dim} for {key}")
        scale = _row_scale(w, 7.0)
        q = torch.clamp(torch.round(w / scale[:, None]), -7, 7).to(torch.int8)
        lo = (q[:, 0::2] & 0x0F).to(torch.uint8)
        hi = (q[:, 1::2] & 0x0F).to(torch.uint8) << 4
        return (lo | hi).view(torch.int8), scale  # [out, in / 2]


@register_quantizer("fp8_weight_only")
class Fp8WeightOnlyQuantizer(Quantizer):
    """float8_e4m3 weight-only with per-channel scales (the reference's
    finegrained-FP8 analog)."""

    def quantize_tensor(self, key, value):
        w = value.float()
        scale = _row_scale(w, float(torch.finfo(torch.float8_e4m3fn).max))
        return (w / scale[:, None]).to(torch.float8_e4m3fn), scale


def unpack_int4_codes(packed: torch.Tensor) -> torch.Tensor:
    """Packed [out, in / 2] int8 -> sign-extended int4 codes [out, in] int8 (no
    scale applied)."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    out_dim, in_half = packed.shape
    return torch.stack([lo, hi], dim=2).reshape(out_dim, in_half * 2).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)[:, None]


def unpack_int4(packed: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return unpack_int4_codes(packed).to(dtype) * scale.to(dtype)[:, None]


def dequantize_fp8(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)[:, None]


def quantized_dot(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                  out_dtype) -> torch.Tensor:
    """y = x @ dequant(w).T computed as (x @ codes.T) * scale: ``w`` the codes
    [out, in] (int8, or fp8; int4 unpacked by ``unpack_int4_codes``), the codes
    and x widened exactly to float32, the products summed in float32, times the
    float32 scale, rounded once to ``out_dtype``. The plain version of the
    port's quantized product."""
    y = torch.matmul(x.float(), w.float().T)
    return (y * scale.float()).to(out_dtype)
