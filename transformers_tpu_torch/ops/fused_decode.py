"""Fused single-token decode step for the H100: ``csrc/fused_decode.cu``.

Replaces the TPU kernel ``transformers_tpu/ops/pallas/fused_decode.py``
(``fused_decode_attention``: both ``_fused_decode_kernel_whole`` and the
chunked ``_fused_decode_kernel``). One call per layer per decode step does:

- rotate-half rope on q and on the new key, from per-row cos/sin (the rope
  position is per row, ``rope_last + g`` under left padding, while the cache
  slot ``pos`` is one Python int shared by the batch);
- the write of the roped key and the value into cache slot ``pos``, in place;
- attention over the cache slots in ``[start, pos)`` that ``kv_valid`` marks
  live, plus the new token's own column.

Rope is computed in f32 on the values cast to q's dtype and rounded once to
that dtype, as the Pallas kernel does; the unfused path ropes in the compute
dtype, so in bf16 the two differ by about one rounding step.

What bounds it on the card, and what the design does about it: see the
note at the top of ``csrc/fused_decode.cu``.

The wrapper takes CUDA tensors to the kernel and CPU tensors to the plain
PyTorch version below, and nothing else: there is no fallback. It counts
its kernel launches in ``fused_decode_attention.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .rope import rotate_half

KERNEL_HEAD_DIMS = (64, 128, 256)
# ttpu_fused_decode(q, k_new, v_new, cos, sin, k_cache, v_cache, start, kv_valid, out,
#                   B, H, KVH, S, D, pos, scale, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def fused_decode_supported(q: torch.Tensor, k_cache: torch.Tensor) -> bool:
    """Shapes the kernel takes; other shapes use the unfused decode path."""
    h, d = q.shape[2], q.shape[3]
    return q.shape[1] == 1 and h % k_cache.shape[1] == 0 and d in KERNEL_HEAD_DIMS


def fused_decode_plain(q, k_new, v_new, cos, sin, k_cache, v_cache, pos: int, start, kv_valid,
                       *, scale: float):
    """Plain PyTorch version of the kernel, with the same rounding points: rope
    in f32 rounded once to q's dtype, f32 scores, softmax and P.V. Writes the
    caches in place and returns the attention output [B, 1, H, D]."""
    b, _, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    g = h // kvh
    dt = q.dtype
    c = cos.to(dt).float()[:, :, None, :]
    sn = sin.to(dt).float()[:, :, None, :]

    def rope(x):
        xf = x.float()
        return (xf * c + rotate_half(xf) * sn).to(dt)

    k_cache[:, :, pos] = rope(k_new)[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v_new[:, 0].to(v_cache.dtype)
    qg = rope(q)[:, 0].reshape(b, kvh, g, d).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * scale
    slots = torch.arange(s, device=q.device)[None, :]
    live = (slots >= start.to(torch.int64)[:, None]) & (slots < pos) & (kv_valid != 0)
    live = live | (slots == pos)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(dt)


def _fused_decode_cuda(q, k_new, v_new, cos, sin, k_cache, v_cache, pos, start, kv_valid,
                       *, scale):
    b, _, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    if q.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"fused decode kernel takes float32/bfloat16/float16, got {q.dtype}")
    if not fused_decode_supported(q, k_cache):
        raise ValueError(f"fused decode kernel shapes: q {tuple(q.shape)} "
                         f"cache {tuple(k_cache.shape)}")
    if (k_cache.shape != (b, kvh, s, d) or v_cache.shape != k_cache.shape
            or k_new.shape != (b, 1, kvh, d) or v_new.shape != k_new.shape
            or cos.shape != (b, 1, d) or sin.shape != cos.shape):
        raise ValueError("fused decode: inconsistent shapes")
    if start.shape != (b,) or kv_valid.shape != (b, s):
        raise ValueError("start must be [B] and kv_valid [B, S]")
    if start.dtype != torch.int32 or kv_valid.dtype != torch.int32:
        raise ValueError("start and kv_valid must be int32")
    if not 0 <= pos < s:
        raise ValueError(f"cache slot {pos} outside [0, {s})")
    cuda_build.check_cuda(dict(q=q, k_new=k_new, v_new=v_new, cos=cos, sin=sin,
                               k_cache=k_cache, v_cache=v_cache, start=start,
                               kv_valid=kv_valid), q.dtype, q.device)
    out = torch.empty_like(q)
    fn = cuda_build.kernel_fn("fused_decode", "ttpu_fused_decode", _ARGTYPES)
    code = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cos.data_ptr(), sin.data_ptr(),
              k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(), kv_valid.data_ptr(),
              out.data_ptr(), b, h, kvh, s, d, int(pos), float(scale),
              cuda_build.DTYPE_CODES[q.dtype], cuda_build.stream_ptr(q.device))
    cuda_build.raise_on_error(code, "fused_decode")
    fused_decode_attention.launches += 1
    return out


def fused_decode_attention(q, k_new, v_new, cos, sin, k_cache, v_cache, pos: int, start,
                           kv_valid, *, scale: float):
    """One decode step. q [B, 1, H, D] and k_new/v_new [B, 1, KVH, D] pre-rope,
    cos/sin [B, 1, D], caches [B, KVH, S, D] (updated in place at slot ``pos``),
    ``start`` [B] first live slot per row, ``kv_valid`` [B, S]. Returns the
    attention output [B, 1, H, D]. Not differentiable: raises when a
    gradient would be needed."""
    cuda_build.refuse_grad("fused_decode_attention", q, k_new, v_new, k_cache, v_cache)
    args = (q, k_new, v_new, cos.to(q.dtype).contiguous(), sin.to(q.dtype).contiguous(),
            k_cache, v_cache, int(pos), start.to(torch.int32).contiguous(),
            kv_valid.to(torch.int32).contiguous())
    if q.device.type == "cuda":
        return _fused_decode_cuda(*args, scale=scale)
    if q.device.type == "cpu":
        return fused_decode_plain(*args, scale=scale)
    raise ValueError(f"fused_decode_attention runs on cuda or cpu, not {q.device}")


fused_decode_attention.launches = 0
