"""Static-cache single-token decode attention for the H100 (K7): the
``static_decode_kernel`` mode of ``csrc/fused_decode.cu``.

Replaces the TPU kernel ``transformers_tpu/ops/pallas/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``). One query token per row attends
over a BSHD static cache ``[B, S, KVH, D]``, reading only that row's live
slots ``[valid_start, valid_end)``; under a sliding window the first live slot
is ``max(valid_start, valid_end - window)``. Query head ``h = kv * G + i``
reads kv head ``kv`` (``G = H // KVH``). The JAX package calls this op from no
model path (its static cache is ``bhsd``, served by the fused decode kernel);
it is ported so that every TPU kernel has a counterpart.

A row with no live slot gives zeros. The Pallas kernel does so only when its
row's live block range is empty; when ``valid_end <= valid_start`` inside one
of its kv blocks it averages that block's V (a finite mask value), which no
caller relies on. Probabilities stay in f32 for the P.V product (the Pallas
kernel computes in f32 too).

There is no ``head_dim % 128`` gate: the kernel is built for head_dim 64, 128
and 256 in float32, bf16 and fp16. It cuts each (row, kv head)'s slots into
splits of ``SPLIT_SLOTS`` (one block each) and merges the splits' f32 (m, l,
acc) partials in split order in the same launch; ``decode_split_plain`` is
that computation in plain PyTorch. What bounds it on the card, and what its
design does about it: see the note at the top of ``csrc/fused_decode.cu``.

The wrapper takes CUDA tensors to the kernel and CPU tensors to the plain
PyTorch version below, and nothing else: there is no fallback. It counts its
kernel launches in ``decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build
from .paged_attention import merge_splits_plain, split_partials_plain

KERNEL_HEAD_DIMS = (64, 128, 256)
# Slots per split, from a one-time sweep (decode_split_sweep.py) on an H100 80GB HBM3 at
# 700 W: at the smoke's shape (B = 8, S = 224, ragged live ranges) 16 / 32 / 64 / 96 / 128 /
# 160 / 224 / 256 / 512 slots took 0.0202 / 0.0145 / 0.0096 / 0.0112 / 0.0091 / 0.0104 /
# 0.0082 / 0.0083 / 0.0082 ms; K2's long-context readings (ops/fused_decode.py) favour 512.
SPLIT_SLOTS = 512
# ttpu_static_decode(q, k, v, valid_start, valid_end, out, scratch, tickets, B, H, KVH, S, D,
#                    window, split_slots, scale, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def decode_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Shapes the kernel takes: one query token, whole GQA groups, head_dim
    64/128/256 (no Mosaic ``head_dim % 128`` gate)."""
    h, d = q.shape[2], q.shape[3]
    return q.shape[1] == 1 and h % k.shape[2] == 0 and d in KERNEL_HEAD_DIMS


def _live_range(valid_start, valid_end, s: int, sliding_window):
    """Each row's live slots [start, end) within [0, S), as int64 [B] each."""
    start = valid_start.long()
    end = valid_end.long()
    if sliding_window:
        start = torch.maximum(start, end - sliding_window)
    return start.clamp_min(0), end.clamp_max(s)


def _scores(q, k, valid_start, valid_end, scale, sliding_window):
    """f32 scores [B, KVH, G, S], -inf outside each row's live slots."""
    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q[:, 0].float().reshape(b, kvh, h // kvh, d)
    scores = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    start, end = _live_range(valid_start, valid_end, s, sliding_window)
    slots = torch.arange(s, device=q.device)[None, :]
    live = (slots >= start[:, None]) & (slots < end[:, None])
    return scores.masked_fill(~live[:, None, None, :], float("-inf"))


def decode_attention_plain(q, k, v, valid_start, valid_end, *, scale: float,
                           sliding_window: Optional[int] = None):
    """Plain PyTorch version of K7: f32 scores, softmax and P.V over the live
    slots, one cast to q's dtype; zeros for a row with no live slot. Returns
    [B, 1, H, D]."""
    b, _, h, d = q.shape
    scores = _scores(q, k, valid_start, valid_end, scale, sliding_window)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float()) / torch.where(l > 0, l, 1.0)
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_split_plain(q, k, v, valid_start, valid_end, *, scale: float,
                       sliding_window: Optional[int] = None, split_slots: int):
    """Plain PyTorch version of the split kernel: the f32 (m, l, acc) partials
    of each split of ``split_slots`` slots, merged in split order, one cast
    to q's dtype. Held to ``decode_attention_plain`` by the tests; returns
    [B, 1, H, D]."""
    s = k.shape[1]
    scores = _scores(q, k, valid_start, valid_end, scale, sliding_window)
    ml, acc = split_partials_plain(scores, v.float().transpose(1, 2), split_slots)
    start, end = _live_range(valid_start, valid_end, s, sliding_window)
    first = start // split_slots
    n_live = torch.where(end > start, (end - 1) // split_slots - first + 1, 0)
    return merge_splits_plain(ml, acc, first, n_live).to(q.dtype)


def _decode_cuda(q, k, v, valid_start, valid_end, *, scale, sliding_window):
    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if q.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"decode kernel takes float32/bfloat16/float16, got {q.dtype}")
    if not decode_supported(q, k):
        raise ValueError(f"decode kernel shapes: q {tuple(q.shape)} cache {tuple(k.shape)}")
    if k.shape != (b, s, kvh, d) or v.shape != k.shape:
        raise ValueError("decode: k and v must both be [B, S, KVH, D] with q's B and D")
    if valid_start.shape != (b,) or valid_end.shape != (b,):
        raise ValueError("valid_start and valid_end must be [B]")
    if valid_start.dtype != torch.int32 or valid_end.dtype != torch.int32:
        raise ValueError("valid_start and valid_end must be int32")
    cuda_build.check_cuda(dict(q=q, k=k, v=v, valid_start=valid_start, valid_end=valid_end),
                          q.dtype, q.device)
    out = torch.empty_like(q)
    if b == 0:
        return out
    ns = -(-s // SPLIT_SLOTS)
    # the splits' partials: acc [B, H, n_splits, D], then (m, l) [B, H, n_splits, 2]
    scratch = torch.empty(b * h * ns * (d + 2), dtype=torch.float32, device=q.device)
    tickets = cuda_build.tickets(q.device, b * h)
    fn = cuda_build.kernel_fn("fused_decode", "ttpu_static_decode", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_start.data_ptr(),
              valid_end.data_ptr(), out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), b, h,
              kvh, s, d, int(sliding_window or 0), SPLIT_SLOTS, float(scale),
              cuda_build.DTYPE_CODES[q.dtype], cuda_build.stream_ptr(q.device))
    cuda_build.raise_on_error(code, "static_decode")
    decode_attention.launches += 1
    return out


def decode_attention(q, k, v, valid_start, valid_end, *, scale: float,
                     sliding_window: Optional[int] = None):
    """Single-token attention over a static BSHD cache. q [B, 1, H, D]; k, v
    [B, S, KVH, D]; ``valid_start`` / ``valid_end`` [B] the first and
    one-past-last live slot of each row. Returns [B, 1, H, D]. Not
    differentiable (the Pallas kernel has no VJP): raises when a gradient
    would be needed."""
    cuda_build.refuse_grad("decode_attention", q, k, v)
    args = (q.contiguous(), k, v, valid_start.to(torch.int32).contiguous(),
            valid_end.to(torch.int32).contiguous())
    kw = dict(scale=float(scale), sliding_window=sliding_window)
    if q.device.type == "cuda":
        return _decode_cuda(*args, **kw)
    if q.device.type == "cpu":
        return decode_attention_plain(*args, **kw)
    raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")


cuda_build.counted(decode_attention)
