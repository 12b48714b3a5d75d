"""Weight-only quantized linear layers on the H100: ``csrc/quantized_linear.cu``.

No TPU kernel is replaced here. The JAX package's ``quantized_dot``
(``transformers_tpu/quantizers/weight_only.py``) feeds the int8 / int4 / fp8
codes to ``dot_general`` and XLA fuses their widening into the product, so
the weight streams from memory at its stored width. PyTorch on CUDA has no
product of int8 codes with bf16 activations, so the port computes the same
``y = round((x @ codes.T) * scale)`` (f32 sums, the scale on the product's
output, one rounding to the activation type) with two hand-written kernels:

- Q1 ``quantized_matmul`` (``quantized_linear_kernel``): straight from the
  codes, for the few rows of a decode step;
- Q2 ``widen_codes`` (``widen_codes_kernel``): the codes widened exactly to
  the activation type into a buffer kept per device and type, then the
  product by ``torch.mm`` (cuBLAS) with an f32 output, scaled in f32 and
  rounded once: for the rows of a prefill or a prefill chunk.

``quantized_linear`` picks Q1 up to ``ROW_THRESHOLD`` rows and Q2 above. What
bounds each kernel and what its design does about it: see the note at the top
of the CUDA source.

The wrappers take CUDA tensors to the kernels and CPU tensors to the plain
PyTorch versions (``quantized_dot``, ``widen_codes_plain``), and nothing else:
there is no fallback. They count their launches in ``.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from ..quantizers.weight_only import quantized_dot, unpack_int4_codes
from . import cuda_build

# kept in step with csrc/quantized_linear.cu: the code types, and the multiple of
# in_features its kernels take (rows of whole 32-bit code words, x rows of whole
# 16-byte pieces)
CODE_TYPES = {"int8": 0, "int4": 1, "fp8": 2}
K_MULTIPLE = 8
# Rows up to which a product goes to Q1; above, to Q2 and cuBLAS. From the sweep
# of chip_smoke.py phase (b) on an H100 80GB HBM3 at 700 W, int8 codes x bf16,
# Q1 / Q2's route in ms at 8, 16 and 32 rows: 4096x4096 0.0189/0.0348,
# 0.0311/0.0354, 0.0582/0.0344; 1024x4096 0.0135/0.0153, 0.0226/0.0154,
# 0.0225/0.0156; 14336x4096 0.0553/0.1175, 0.1044/0.1182, 0.1961/0.1171;
# 4096x14336 0.0567/0.1169, 0.0893/0.1173, 0.1738/0.1178. A layer's seven
# projections take 0.4055 against 0.4553 ms at 16 rows and 0.7274 against
# 0.4520 at 32, so a decode step of up to 16 rows stays on Q1.
ROW_THRESHOLD = 16
# ttpu_quantized_linear(x, w, scale, y, M, N, K, code, dtype, stream)
_LINEAR_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
# ttpu_widen_codes(w, out, N, K, code, dtype, stream)
_WIDEN_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)

_WIDE: dict = {}  # (device, dtype) -> Q2's buffer of widened codes
_RETIRED: list = []  # outgrown Q2 buffers, kept: a captured graph may still point at one


def code_type(codes: torch.Tensor, in_features: int) -> str:
    """"int8", "int4" (packed [out, in / 2]) or "fp8" for a quantized weight."""
    if codes.dtype == torch.float8_e4m3fn:
        return "fp8"
    if codes.dtype != torch.int8:
        raise ValueError(f"quantized weights are int8, packed int4 or float8_e4m3fn, "
                         f"got {codes.dtype}")
    if codes.shape[1] == in_features:
        return "int8"
    if codes.shape[1] * 2 == in_features:
        return "int4"
    raise ValueError(f"codes {tuple(codes.shape)} fit neither int8 nor packed int4 for "
                     f"{in_features} input features")


def widen_codes_plain(codes: torch.Tensor, in_features: int, dtype: torch.dtype) -> torch.Tensor:
    """Plain version of Q2: the codes as ``dtype`` [out, in], exactly (no scale)."""
    if code_type(codes, in_features) == "int4":
        codes = unpack_int4_codes(codes)
    return codes.to(dtype)


def _check_in_features(in_features: int) -> None:
    if in_features % K_MULTIPLE:
        raise ValueError(f"the quantized linear kernels take in_features a multiple of "
                         f"{K_MULTIPLE}, got {in_features}")


def _check(x, codes, scale, in_features):
    n = codes.shape[0]
    _check_in_features(in_features)
    if x.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"quantized linear kernels take float32/bfloat16/float16 "
                         f"activations, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != in_features or scale.shape != (n,) \
            or scale.dtype != torch.float32:
        raise ValueError(f"quantized linear: x {tuple(x.shape)}, codes {tuple(codes.shape)}, "
                         f"scale {tuple(scale.shape)} {scale.dtype}")
    for t, dtype in ((x, x.dtype), (codes, codes.dtype), (scale, torch.float32)):
        cuda_build.check_cuda({"x/codes/scale": t}, dtype, x.device)


def quantized_matmul(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                     in_features: int) -> torch.Tensor:
    """Q1: ``round((x @ codes.T) * scale)`` [M, out] in x's dtype from x [M, in],
    codes [out, in] (int8, fp8) or [out, in / 2] (packed int4) and scale [out]
    f32, with f32 sums. On CPU tensors, the plain version ``quantized_dot``."""
    kind = code_type(codes, in_features)
    if x.device.type == "cpu":
        w = unpack_int4_codes(codes) if kind == "int4" else codes
        return quantized_dot(x, w, scale, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on cuda or cpu, not {x.device}")
    _check(x, codes, scale, in_features)
    m, n = x.shape[0], codes.shape[0]
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    fn = cuda_build.kernel_fn("quantized_linear", "ttpu_quantized_linear", _LINEAR_ARGTYPES)
    code = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, in_features,
              CODE_TYPES[kind], cuda_build.DTYPE_CODES[x.dtype], cuda_build.stream_ptr(x.device))
    cuda_build.raise_on_error(code, "quantized_linear")
    quantized_matmul.launches += 1
    return y


def _wide_buffer(device: torch.device, dtype: torch.dtype, numel: int) -> torch.Tensor:
    """Q2's buffer on ``device``: at least ``numel`` elements of ``dtype``, reused by
    every call (calls run in stream order). Grown at a call outside CUDA graph
    capture; an outgrown buffer stays allocated, since a graph captured
    earlier (a decode step above ``ROW_THRESHOLD`` rows) replays into it."""
    buf = _WIDE.get((device, dtype))
    if buf is None or buf.numel() < numel:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("Q2's buffer is allocated at a first call outside CUDA graph "
                               "capture")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.empty(numel, dtype=dtype, device=device)
        _WIDE[(device, dtype)] = buf
    return buf


def widen_codes(codes: torch.Tensor, in_features: int, dtype: torch.dtype) -> torch.Tensor:
    """Q2: the codes widened exactly to ``dtype`` [out, in], no scale. On the card
    the result is a view of a buffer that the next call overwrites. On CPU
    tensors, the plain version."""
    if codes.device.type == "cpu":
        return widen_codes_plain(codes, in_features, dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"widen_codes runs on cuda or cpu, not {codes.device}")
    if dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"widen_codes widens to float32/bfloat16/float16, not {dtype}")
    kind = code_type(codes, in_features)
    _check_in_features(in_features)
    cuda_build.check_cuda(dict(codes=codes), codes.dtype, codes.device)
    n = codes.shape[0]
    out = _wide_buffer(codes.device, dtype, n * in_features)[:n * in_features].view(
        n, in_features)
    fn = cuda_build.kernel_fn("quantized_linear", "ttpu_widen_codes", _WIDEN_ARGTYPES)
    code = fn(codes.data_ptr(), out.data_ptr(), n, in_features, CODE_TYPES[kind],
              cuda_build.DTYPE_CODES[dtype], cuda_build.stream_ptr(codes.device))
    cuda_build.raise_on_error(code, "widen_codes")
    widen_codes.launches += 1
    return out


def _widened_matmul(x, codes, scale, in_features):
    """Q2's route: the widened codes through ``torch.mm`` with an f32 output (the
    products of exact operands summed in f32), scaled in f32, rounded once."""
    w = widen_codes(codes, in_features, x.dtype)
    if x.dtype == torch.float32 or x.device.type == "cpu":
        return quantized_dot(x, w, scale, x.dtype)
    return (torch.mm(x, w.T, out_dtype=torch.float32) * scale).to(x.dtype)


def quantized_linear(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, *,
                     in_features: int) -> torch.Tensor:
    """``round((x @ codes.T) * scale)`` over x's last dim [..., in] -> [..., out] in
    x's dtype: Q1 up to ``ROW_THRESHOLD`` rows, Q2 and ``torch.mm`` above. Not
    differentiable: raises when a gradient would be needed."""
    cuda_build.refuse_grad("quantized_linear", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] <= ROW_THRESHOLD:
        y = quantized_matmul(x2, codes, scale, in_features)
    else:
        y = _widened_matmul(x2, codes, scale, in_features)
    return y.reshape(*lead, codes.shape[0])


cuda_build.counted(quantized_matmul)
cuda_build.counted(widen_codes)
