"""Fused single-token decode step for the H100: ``csrc/fused_decode.cu``.

Replaces the TPU kernel ``transformers_tpu/ops/pallas/fused_decode.py``
(``fused_decode_attention``: both ``_fused_decode_kernel_whole`` and the
chunked ``_fused_decode_kernel``). One call per layer per decode step does:

- rotate-half rope on q and on the new key, from per-row cos/sin (the rope
  position is per row, ``rope_last + g`` under left padding, while the cache
  slot ``pos`` is shared by the batch);
- the write of the roped key and the value into cache slot ``pos``, in place;
- attention over the cache slots in ``[start, pos)`` that ``kv_valid`` marks
  live, plus the new token's own column.

``pos`` is a one-element int32 tensor on q's device, which the kernel reads
there, as the Pallas kernel reads it by scalar prefetch: a captured CUDA
graph of the step replays at whatever slot the tensor holds. A Python int is
accepted too (the wrapper then makes that tensor). The static cache owns one
such tensor (``StaticKVCache.slot``): ``generate()``'s decode loop sets it
once and each (captured) step advances it on the card.

Rope is computed in f32 on the values cast to q's dtype and rounded once to
that dtype, as the Pallas kernel does; the unfused path ropes in the compute
dtype, so in bf16 the two differ by about one rounding step.

The kernel cuts each (row, kv head)'s slots into splits of ``SPLIT_SLOTS``
(one block each) and merges the splits' f32 (m, l, acc) partials in split
order, the new column last, in the same launch; ``fused_decode_split_plain``
is that computation in plain PyTorch. What bounds it on the card, and what
the design does about it: see the note at the top of ``csrc/fused_decode.cu``.

The wrapper takes CUDA tensors to the kernel and CPU tensors to the plain
PyTorch version below, and nothing else: there is no fallback. It counts
its kernel launches in ``fused_decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from . import cuda_build
from .paged_attention import merge_splits_plain, split_partials_plain
from .rope import rotate_half

KERNEL_HEAD_DIMS = (64, 96, 128, 256)
# Slots per split, from a one-time sweep (decode_split_sweep.py) on an H100 80GB HBM3 at
# 700 W: at the generate shape 16 / 32 / 64 / 96 / 128 / 160 / 224 / 256 / 512 slots took
# 0.0212 / 0.0151 / 0.0109 / 0.0105 / 0.0105 / 0.0084 / 0.0084 / 0.0084 / 0.0084 ms (from 160
# on, every row fits in one split), and at S = 4096, pos = 4000 0.3963 / 0.2077 / 0.1178 /
# 0.0981 / 0.0789 / 0.0753 / 0.0696 / 0.0622 / 0.0568 ms. Larger sizes were not measured.
SPLIT_SLOTS = 512
# ttpu_fused_decode(q, k_new, v_new, cos, sin, k_cache, v_cache, start, kv_valid, pos, out,
#                   scratch, tickets, B, H, KVH, S, D, split_slots, scale, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 13 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def fused_decode_supported(q: torch.Tensor, k_cache: torch.Tensor) -> bool:
    """Shapes the kernel takes; other shapes use the unfused decode path."""
    h, d = q.shape[2], q.shape[3]
    return q.shape[1] == 1 and h % k_cache.shape[1] == 0 and d in KERNEL_HEAD_DIMS


def _rope(x, cos, sin):
    """Rotate-half rope in f32 on x, cos and sin as q's dtype holds them,
    rounded once to that dtype (cos/sin [B, 1, D])."""
    dt = x.dtype
    c = cos.to(dt).float()[:, :, None, :]
    sn = sin.to(dt).float()[:, :, None, :]
    xf = x.float()
    return (xf * c + rotate_half(xf) * sn).to(dt)


def _write_and_score(q, k_new, v_new, cos, sin, k_cache, v_cache, pos: int, start, kv_valid,
                     scale):
    """Writes the roped new key and the value at slot ``pos`` and returns the
    f32 scores [B, KVH, G, S] of the cache slots in [start, pos) that
    kv_valid marks live (-inf elsewhere, slot pos included) and the new
    column's score [B, KVH, G]."""
    b, _, h, d = q.shape
    kvh, s = k_cache.shape[1], k_cache.shape[2]
    k_roped = _rope(k_new, cos, sin)
    k_cache[:, :, pos] = k_roped[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v_new[:, 0].to(v_cache.dtype)
    qg = _rope(q, cos, sin)[:, 0].reshape(b, kvh, h // kvh, d).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) * scale
    slots = torch.arange(s, device=q.device)[None, :]
    live = (slots >= start.to(torch.int64)[:, None]) & (slots < pos) & (kv_valid != 0)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    s_new = torch.einsum("bhgd,bhd->bhg", qg, k_roped[:, 0].float()) * scale
    return scores, s_new


def fused_decode_plain(q, k_new, v_new, cos, sin, k_cache, v_cache, pos: int, start, kv_valid,
                       *, scale: float):
    """Plain PyTorch version of the kernel, with the same rounding points: rope
    in f32 rounded once to q's dtype, f32 scores, softmax and P.V. Writes the
    caches in place and returns the attention output [B, 1, H, D]."""
    b, _, h, d = q.shape
    scores, s_new = _write_and_score(q, k_new, v_new, cos, sin, k_cache, v_cache, pos, start,
                                     kv_valid, scale)
    scores = torch.cat([scores, s_new[..., None]], dim=-1)  # the new column, slot pos
    values = torch.cat([v_cache.float(), v_new[:, 0].float()[:, :, None, :]], dim=2)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, values)
    return out.reshape(b, 1, h, d).to(q.dtype)


def fused_decode_split_plain(q, k_new, v_new, cos, sin, k_cache, v_cache, pos: int, start,
                             kv_valid, *, scale: float, split_slots: int):
    """Plain PyTorch version of the split kernel: the f32 (m, l, acc) partials
    of each split of ``split_slots`` cache slots, merged in split order with
    the new column last, one cast to q's dtype. Writes the caches in place as
    the kernel does. Held to ``fused_decode_plain`` by the tests; returns
    [B, 1, H, D]."""
    b, _, h, d = q.shape
    kvh = k_cache.shape[1]
    scores, s_new = _write_and_score(q, k_new, v_new, cos, sin, k_cache, v_cache, pos, start,
                                     kv_valid, scale)
    ml, acc = split_partials_plain(scores, v_cache.float(), split_slots)
    lo = start.to(torch.int64).clamp_min(0)
    first = lo // split_slots
    n_live = torch.where(pos > lo, (pos - 1) // split_slots - first + 1, 0)
    v_heads = v_new[:, 0].float().repeat_interleave(h // kvh, dim=1)  # [B, H, D]
    out = merge_splits_plain(ml, acc, first, n_live, new=(s_new.reshape(b, h), v_heads))
    return out.to(q.dtype)


def _pos_tensor(pos, s: int, device: torch.device) -> torch.Tensor:
    """``pos`` as the kernel reads it: a one-element int32 tensor on ``device``.
    A Python int is range-checked here; a tensor's value is checked by the
    kernel, which writes no cache slot and gives NaN outputs for a slot
    outside [0, S)."""
    if isinstance(pos, torch.Tensor):
        if pos.numel() != 1 or pos.dtype != torch.int32 or pos.device != device:
            raise ValueError(f"pos must be one int32 on {device}, got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        return pos
    if not 0 <= int(pos) < s:
        raise ValueError(f"cache slot {pos} outside [0, {s})")
    return torch.full((1,), int(pos), dtype=torch.int32, device=device)


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
    pos = _pos_tensor(pos, s, q.device)
    cuda_build.check_cuda(dict(q=q, k_new=k_new, v_new=v_new, cos=cos, sin=sin,
                               k_cache=k_cache, v_cache=v_cache, start=start,
                               kv_valid=kv_valid, pos=pos), q.dtype, q.device)
    out = torch.empty_like(q)
    ns = -(-s // SPLIT_SLOTS)
    # the splits' partials: acc [B, H, n_splits, D], then (m, l) [B, H, n_splits, 2]
    scratch = torch.empty(b * h * ns * (d + 2), dtype=torch.float32, device=q.device)
    tickets = cuda_build.tickets(q.device, b * h)
    fn = cuda_build.kernel_fn("fused_decode", "ttpu_fused_decode", _ARGTYPES)
    code = fn(q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cos.data_ptr(), sin.data_ptr(),
              k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(), kv_valid.data_ptr(),
              pos.data_ptr(), out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), b, h, kvh,
              s, d, SPLIT_SLOTS, float(scale), cuda_build.DTYPE_CODES[q.dtype],
              cuda_build.stream_ptr(q.device))
    cuda_build.raise_on_error(code, "fused_decode")
    fused_decode_attention.launches += 1
    return out


def fused_decode_attention(q, k_new, v_new, cos, sin, k_cache, v_cache,
                           pos: Union[int, torch.Tensor], start, kv_valid, *, scale: float):
    """One decode step. q [B, 1, H, D] and k_new/v_new [B, 1, KVH, D] pre-rope,
    cos/sin [B, 1, D], caches [B, KVH, S, D] (updated in place at slot ``pos``),
    ``pos`` a one-element int32 tensor on q's device or a Python int,
    ``start`` [B] first live slot per row, ``kv_valid`` [B, S]. Returns the
    attention output [B, 1, H, D]. Not differentiable: raises when a
    gradient would be needed."""
    cuda_build.refuse_grad("fused_decode_attention", q, k_new, v_new, k_cache, v_cache)
    args = (q, k_new, v_new, cos.to(q.dtype).contiguous(), sin.to(q.dtype).contiguous(),
            k_cache, v_cache)
    tail = (start.to(torch.int32).contiguous(), kv_valid.to(torch.int32).contiguous())
    if q.device.type == "cuda":
        return _fused_decode_cuda(*args, pos, *tail, scale=scale)
    if q.device.type == "cpu":
        return fused_decode_plain(*args, int(pos), *tail, scale=scale)
    raise ValueError(f"fused_decode_attention runs on cuda or cpu, not {q.device}")


cuda_build.counted(fused_decode_attention)
