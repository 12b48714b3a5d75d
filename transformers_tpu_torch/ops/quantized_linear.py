"""Weight-only quantized linear layers on the H100: ``csrc/quantized_linear.cu``.

No TPU kernel is replaced here. The JAX package's ``quantized_dot``
(``transformers_tpu/quantizers/weight_only.py``) feeds the int8 / int4 / fp8
codes to ``dot_general`` and XLA fuses their widening into the product, so
the weight streams from memory at its stored width. PyTorch on CUDA has no
product of int8 codes with bf16 activations, so the port computes the same
``y = round((x @ codes.T) * scale)`` (f32 sums, the scale on the product's
output, one rounding to the activation type) with two hand-written kernels:

- Q1 ``quantized_matmul``: straight from the codes, for the rows of a decode
  step or a short prefill chunk. bf16 and f16 activations take the
  tensor-core kernel (``quantized_linear_tc_kernel``, at most
  ``MAX_TC_ROWS`` rows), which cuts K into splits of ``split_size`` values
  and merges their f32 partials in split order in the same launch
  (``quantized_matmul_split_plain`` is that computation in plain PyTorch);
  f32 activations take exact f32 FMAs on the CUDA cores
  (``quantized_linear_kernel``);
- Q2 ``widen_codes`` (``widen_codes_kernel``): the codes widened exactly to
  the activation type into a buffer kept per device and type, then the
  product by ``torch.mm`` (cuBLAS) with an f32 output, scaled in f32 and
  rounded once: for the rows of a prefill or a longer prefill chunk.

``quantized_linear`` picks Q1 up to ``ROW_THRESHOLD`` rows (f32:
``F32_ROW_THRESHOLD``) and Q2 above. What
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
# Rows up to which a bf16/f16 product goes to Q1; above, to Q2 and cuBLAS. From
# the sweep of chip_smoke.py phase (b) on an H100 80GB HBM3 at 700 W, int8
# codes x bf16, a Llama-3-8B layer's seven projections, Q1 / Q2's route in ms:
# 1 row 0.1160 / 0.4453, 16 0.1403 / 0.4540, 32 0.1768 / 0.4519, 64 0.2467 /
# 0.4601, 128 0.4345 / 0.4886 (1024x4096 alone: Q1 0.0241 / 0.0431 against
# 0.0165 / 0.0173 at 64 / 128 rows). So every row count Q1 takes, up to
# MAX_TC_ROWS (CB's prefill budget), stays on Q1.
ROW_THRESHOLD = 128
# The same for f32 activations, whose Q1 is the CUDA-core kernel that reads the
# codes once per 16 rows: the same sweep of that kernel (with bf16 activations,
# at 8 / 16 / 32 rows; a layer's seven 0.4055 / 0.7274 ms against Q2's route's
# 0.4553 / 0.4520 at 16 / 32) crossed over above 16 rows.
F32_ROW_THRESHOLD = 16
# kept in step with csrc/quantized_linear.cu: the tensor-core Q1's K values per
# pipeline chunk (a split is a whole number of them), weight rows per block
# and most activation rows
CHUNK = 256
TC_ROWS = 128
MAX_TC_ROWS = 128
# Q1's split of K (split_size): as many splits as keep the row blocks times
# the splits within TARGET_BLOCKS, one block an SM. From quantized_linear_sweep.py
# on an H100 80GB HBM3 at 700 W, int8 x bf16, ms at 1 / 16 / 64 rows by
# splits: 14336x4096 (112 row blocks) 1: 0.0267 / 0.0286 / 0.0456, 2: 0.0310 /
# 0.0382 / 0.0710; 4096x14336 (32) 3: 0.0314 / 0.0377 / 0.0723, 4: 0.0286 /
# 0.0333 / 0.0534, 6: 0.0358 / 0.0450 / 0.0854; 4096x4096 (32) 3: 0.0135 /
# 0.0181 / 0.0381, 4: 0.0116 / 0.0152 / 0.0291, 6: 0.0153 / 0.0223 / 0.0491;
# 1024x4096 (8) 8: 0.0069 / 0.0103 / 0.0233, 16: 0.0067 / 0.0105 / 0.0240.
TARGET_BLOCKS = 132
# ttpu_quantized_linear(x, w, scale, y, partials, tickets, M, N, K, split, code, dtype, stream)
_LINEAR_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)
# ttpu_widen_codes(w, out, N, K, code, dtype, stream)
_WIDEN_ARGTYPES = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)

_WIDE: dict = {}  # (device, dtype) -> Q2's buffer of widened codes
_PARTIALS: dict = {}  # device -> Q1's buffer of the splits' f32 partials
_RETIRED: list = []  # outgrown buffers, kept: a captured graph may still point at one


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


def split_size(n: int, k: int) -> int:
    """K values per split of the tensor-core Q1 for an [n, k] weight: a whole
    number of CHUNKs, as many splits as keep the blocks of TC_ROWS weight
    rows within TARGET_BLOCKS (at least one)."""
    chunks = -(-k // CHUNK)
    splits = min(chunks, max(1, TARGET_BLOCKS // -(-n // TC_ROWS)))
    return -(-chunks // splits) * CHUNK


def quantized_matmul_split_plain(x: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                                 in_features: int, split: int) -> torch.Tensor:
    """Plain PyTorch version of the tensor-core Q1: the f32 sums of each split
    of ``split`` input features (the products of exact operands), added in
    split order, times the f32 scale, rounded once to x's dtype."""
    w = unpack_int4_codes(codes) if code_type(codes, in_features) == "int4" else codes
    acc = None
    for k0 in range(0, in_features, split):
        part = torch.matmul(x[:, k0:k0 + split].float(), w[:, k0:k0 + split].float().T)
        acc = part if acc is None else acc + part
    return (acc * scale.float()).to(x.dtype)


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
    f32, with f32 sums. bf16/f16 x of at most MAX_TC_ROWS rows take the
    tensor-core kernel, its K cut into splits of ``split_size`` values. On CPU
    tensors, the plain version ``quantized_dot``."""
    if x.device.type == "cpu":
        w = unpack_int4_codes(codes) if code_type(codes, in_features) == "int4" else codes
        return quantized_dot(x, w, scale, x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quantized_matmul runs on cuda or cpu, not {x.device}")
    fn = cuda_build.kernel_fn("quantized_linear", "ttpu_quantized_linear", _LINEAR_ARGTYPES)
    y = launch_q1(fn, x, codes, scale, in_features)
    quantized_matmul.launches += 1
    return y


def launch_q1(fn, x, codes, scale, in_features, split=None, chunk=CHUNK):
    """One launch of ``ttpu_quantized_linear`` (``fn``) on CUDA tensors,
    returning y; K cut into splits of ``split`` values (default
    ``split_size``). quantized_linear_sweep.py passes a variant's build, its
    chunk and each split it times."""
    _check(x, codes, scale, in_features)
    m, n = x.shape[0], codes.shape[0]
    partials = tickets = None
    if x.dtype == torch.float32:
        split = 0
    else:
        if m > MAX_TC_ROWS:
            raise ValueError(f"quantized_matmul takes at most {MAX_TC_ROWS} bf16/f16 rows, "
                             f"got {m}")
        split = split_size(n, in_features) if split is None else split
        if split <= 0 or split % chunk:
            raise ValueError(f"split must be a positive multiple of {chunk}, got {split}")
        splits = -(-in_features // split)
        if splits > 1:
            partials = _kept_buffer(_PARTIALS, x.device, x.device, torch.float32,
                                    splits * m * n, "Q1's partials")
            tickets = cuda_build.tickets(x.device, -(-n // TC_ROWS))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    code = fn(x.data_ptr(), codes.data_ptr(), scale.data_ptr(), y.data_ptr(),
              None if partials is None else partials.data_ptr(),
              None if tickets is None else tickets.data_ptr(), m, n, in_features, split,
              CODE_TYPES[code_type(codes, in_features)], cuda_build.DTYPE_CODES[x.dtype],
              cuda_build.stream_ptr(x.device))
    cuda_build.raise_on_error(code, "quantized_linear")
    return y


def _kept_buffer(store: dict, key, device: torch.device, dtype: torch.dtype, numel: int,
                 what: str) -> torch.Tensor:
    """``store[key]``: at least ``numel`` elements of ``dtype`` on ``device``,
    reused by every call (calls run in stream order). Grown at a call outside
    CUDA graph capture; an outgrown buffer stays allocated in ``_RETIRED``,
    since a graph captured earlier replays into it."""
    buf = store.get(key)
    if buf is None or buf.numel() < numel:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{what} is allocated at a first call outside CUDA graph "
                               f"capture")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.empty(numel, dtype=dtype, device=device)
        store[key] = buf
    return buf


def _wide_buffer(device: torch.device, dtype: torch.dtype, numel: int) -> torch.Tensor:
    """Q2's buffer on ``device``: at least ``numel`` elements of ``dtype``
    (``_kept_buffer``; a decode step above ``ROW_THRESHOLD`` rows captures
    it)."""
    return _kept_buffer(_WIDE, (device, dtype), device, dtype, numel, "Q2's buffer")


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
    x's dtype: Q1 up to ``ROW_THRESHOLD`` rows (f32: ``F32_ROW_THRESHOLD``), Q2
    and ``torch.mm`` above. Not differentiable: raises when a gradient would
    be needed."""
    cuda_build.refuse_grad("quantized_linear", x)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.shape[0] <= (F32_ROW_THRESHOLD if x.dtype == torch.float32 else ROW_THRESHOLD):
        y = quantized_matmul(x2, codes, scale, in_features)
    else:
        y = _widened_matmul(x2, codes, scale, in_features)
    return y.reshape(*lead, codes.shape[0])


cuda_build.counted(quantized_matmul)
cuda_build.counted(widen_codes)
