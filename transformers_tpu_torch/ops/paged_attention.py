"""Paged single-token decode attention for the H100: ``csrc/paged_decode.cu``.

Replaces the TPU kernel ``transformers_tpu/ops/pallas/paged_attention.py``
(``paged_decode_attention`` / ``_paged_decode_kernel``), the attention of
every continuous-batching decode step. K/V live in page pools ``[P, KVH, BS,
D]``; row ``n`` reads its slots ``[start, ctx_lens[n])`` through
``block_tables[n]`` (slot ``j`` is offset ``j % BS`` of page
``block_tables[n, j // BS]``), with ``start = max(ctx - window, 0)`` under a
sliding window and 0 otherwise. The new token's k/v are already in the pool
when this runs (the CB runner scatters them first). A row with ``ctx = 0``
gives zeros; pad rows of a decode bucket have ``ctx = 1`` on the null page.

Unlike the Pallas kernel, which fetches dead pages (the null page)
branch-free and casts the probabilities to the pool's dtype before P.V, the
CUDA kernel reads live pages only and keeps P.V in f32. It cuts each row's
slots into splits of ``SPLIT_SLOTS`` (one block each) and merges the splits'
f32 (m, l, acc) partials in split order in a second kernel, launched by the
same C call (``paged_decode_combine`` launches it alone);
``paged_decode_split_plain`` is that computation in plain PyTorch. What
bounds it on the card, and what the design does about it: see the note at
the top of ``csrc/paged_decode.cu``.

``paged_decode_attention`` takes CUDA tensors to the kernels and CPU tensors
to the plain PyTorch version, and nothing else: there is no fallback.
``paged_decode_combine``, the merge kernel alone, takes CUDA tensors only.
The launches are counted in ``paged_decode_attention.launches`` (the split
pass) and ``paged_decode_combine.launches`` (the merge).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

KERNEL_HEAD_DIMS = (64, 96, 128, 256)
# Slots per split (rounded up to whole pages): the fastest of 32 / 64 / 128 / 256 / 640
# (0.0145 / 0.0118 / 0.0127 / 0.0182 / 0.0260 ms) at the continuous-batching shape, in a
# one-time sweep on an H100 80GB HBM3 at 700 W (see csrc/paged_decode.cu and PERF.md).
SPLIT_SLOTS = 64
MAX_SPLIT_PAGES = 64  # csrc/paged_decode.cu kMaxSplitPages
# ttpu_paged_decode(q, k_pool, v_pool, block_tables, ctx_lens, out, part_ml, part_acc,
#                   N, H, KVH, BS, D, MAXB, window, scale, split_slots, n_splits, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
# ttpu_paged_decode_combine(ctx_lens, part_ml, part_acc, out, N, H, D, max_slots, window,
#                           split_slots, n_splits, dtype, stream)
_COMBINE_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def paged_decode_supported(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """Shapes the kernel takes; other shapes use the gather path."""
    h, d = q.shape[2], q.shape[3]
    return q.shape[1] == 1 and h % k_pool.shape[1] == 0 and d in KERNEL_HEAD_DIMS


def split_size(block_size: int) -> int:
    """The kernel's split: ``SPLIT_SLOTS`` rounded up to whole pages of
    ``block_size`` slots."""
    return max(1, -(-SPLIT_SLOTS // block_size)) * block_size


def _gather(pool, block_tables):
    """[P, KVH, BS, D] pages of each row, f32: [N, KVH, MAXB * BS, D]."""
    n, maxb = block_tables.shape
    _, kvh, bs, d = pool.shape
    pages = pool[block_tables.long()].float()
    return pages.permute(0, 2, 1, 3, 4).reshape(n, kvh, maxb * bs, d)


def _scores(q, k_pool, block_tables, ctx_lens, scale, sliding_window):
    """f32 scores [N, KVH, G, MAXB * BS], -inf outside each row's [start, ctx)."""
    n, _, h, d = q.shape
    kvh = k_pool.shape[1]
    qg = q[:, 0].float().reshape(n, kvh, h // kvh, d)
    s = torch.einsum("nhgd,nhsd->nhgs", qg, _gather(k_pool, block_tables)) * scale
    ctx = ctx_lens.long()[:, None]
    j = torch.arange(s.shape[-1], device=q.device)[None, :]
    live = j < ctx
    if sliding_window is not None:
        live = live & (j >= ctx - sliding_window)
    return s.masked_fill(~live[:, None, None, :], float("-inf"))


def paged_decode_plain(q, k_pool, v_pool, block_tables, ctx_lens, *, scale: float,
                       sliding_window: Optional[int] = None):
    """Plain PyTorch version of the kernel, with the same rounding points: f32
    scores, softmax and P.V over the gathered pages, one cast to q's dtype.
    Returns [N, 1, H, D]."""
    n, _, h, d = q.shape
    s = _scores(q, k_pool, block_tables, ctx_lens, scale, sliding_window)
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("nhgs,nhsd->nhgd", p, _gather(v_pool, block_tables))
    out = out / torch.where(l > 0, l, 1.0)
    return out.reshape(n, 1, h, d).to(q.dtype)


def _live_splits(ctx_lens, max_slots: int, split_slots: int, sliding_window):
    """Per row: the first split its live slots [start, ctx) touch and how many."""
    ctx = ctx_lens.long().clamp(0, max_slots)
    start = (ctx - sliding_window).clamp_min(0) if sliding_window else torch.zeros_like(ctx)
    first = start // split_slots
    n_live = torch.where(ctx > start, (ctx - 1) // split_slots - first + 1, 0)
    return first, n_live


def split_partials_plain(scores, v, split_slots: int):
    """Each split's f32 partials, as the split-KV decode kernels (K2, K6, K7)
    form them, from f32 scores [N, KVH, G, slots] (-inf where a slot is not
    live) and values [N, KVH, slots, D]: ``ml`` [N, H, n_splits, 2] holds the
    split's score max m and sum l of exp(s - m), ``acc`` [N, H, n_splits, D]
    the sum of exp(s - m) v. A split with no live slot has m = -inf, l = 0,
    acc = 0. n_splits = ceil(slots / split_slots)."""
    n, kvh, g, slots = scores.shape
    d = v.shape[-1]
    ns = -(-slots // split_slots)
    pad = ns * split_slots - slots
    s = torch.nn.functional.pad(scores, (0, pad), value=float("-inf"))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    s = s.reshape(n, kvh, g, ns, split_slots)
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    acc = torch.einsum("nhgkj,nhkjd->nhgkd", p, v.reshape(n, kvh, ns, split_slots, d))
    ml = torch.stack([m, p.sum(dim=-1)], dim=-1)
    return ml.reshape(n, kvh * g, ns, 2), acc.reshape(n, kvh * g, ns, d)


def merge_splits_plain(ml, acc, first, n_live, *, new=None):
    """The merge of the splits' partials, in split order, as the kernels do
    it: row n's live splits are ``first[n]`` .. ``first[n] + n_live[n] - 1``;
    M = their largest m (and the new column's score), then L and A summed
    over the splits one after the other with weights exp(m - M), the new
    column last; out = A / L (0 where the row has nothing live). ``new``:
    K2's new column, (score [N, H], value [N, H, D]) in f32, or None. Returns
    f32 [N, 1, H, D]."""
    n, h, ns, d = acc.shape
    k = torch.arange(ns, device=acc.device)[None, :]
    live = (k >= first[:, None]) & (k < (first + n_live)[:, None])  # [N, n_splits]
    m = ml[..., 0].masked_fill(~live[:, None, :], float("-inf"))
    top = m.amax(dim=-1, keepdim=True)
    if new is not None:
        top = torch.maximum(top, new[0][..., None])
    f = torch.where(live[:, None, :], torch.exp(m - torch.where(torch.isfinite(top), top, 0.0)),
                    0.0)
    total_l = torch.zeros((n, h), dtype=torch.float32, device=acc.device)
    total_a = torch.zeros((n, h, d), dtype=torch.float32, device=acc.device)
    for i in range(ns):
        total_l = total_l + ml[:, :, i, 1] * f[:, :, i]
        total_a = total_a + acc[:, :, i] * f[:, :, i, None]
    if new is not None:
        p_new = torch.exp(new[0] - top[..., 0])
        total_l = total_l + p_new
        total_a = total_a + p_new[..., None] * new[1]
    out = total_a / torch.where(total_l > 0, total_l, 1.0)[..., None]
    return out.reshape(n, 1, h, d)


def paged_decode_partials_plain(q, k_pool, v_pool, block_tables, ctx_lens, *, scale: float,
                                sliding_window: Optional[int] = None, split_slots: int):
    """Each split's f32 partials, as the split kernel forms them
    (``split_partials_plain`` over the gathered pages); n_splits = ceil(MAXB
    * BS / split_slots)."""
    s = _scores(q, k_pool, block_tables, ctx_lens, scale, sliding_window)
    return split_partials_plain(s, _gather(v_pool, block_tables), split_slots)


def paged_decode_merge_plain(ml, acc, ctx_lens, *, max_slots: int, split_slots: int,
                             sliding_window: Optional[int] = None):
    """The merge of K6's split partials in split order (``merge_splits_plain``
    over each row's live splits). Returns f32 [N, 1, H, D]."""
    first, n_live = _live_splits(ctx_lens, max_slots, split_slots, sliding_window)
    return merge_splits_plain(ml, acc, first, n_live)


def paged_decode_split_plain(q, k_pool, v_pool, block_tables, ctx_lens, *, scale: float,
                             sliding_window: Optional[int] = None, split_slots: int):
    """Plain PyTorch version of the split kernel and its merge: each split's
    f32 (m, l, acc), merged in split order, one cast to q's dtype. Held to
    ``paged_decode_plain`` by the tests; returns [N, 1, H, D]."""
    ml, acc = paged_decode_partials_plain(q, k_pool, v_pool, block_tables, ctx_lens,
                                          scale=scale, sliding_window=sliding_window,
                                          split_slots=split_slots)
    max_slots = block_tables.shape[1] * k_pool.shape[2]
    out = paged_decode_merge_plain(ml, acc, ctx_lens, max_slots=max_slots,
                                   split_slots=split_slots, sliding_window=sliding_window)
    return out.to(q.dtype)


def paged_decode_combine(ctx_lens, ml, acc, out, *, max_slots: int, split_slots: int,
                         sliding_window: Optional[int] = None):
    """The merge kernel alone, on CUDA tensors: writes ``out`` [N, 1, H, D] at
    each row whose live slots span more than one split, from the partials
    ``ml`` [N, H, n_splits, 2] and ``acc`` [N, H, n_splits, D] (f32) of those
    splits, merged in split order; other rows are left as they are. Its plain
    version is ``paged_decode_merge_plain``. Returns ``out``."""
    n, h, ns, d = acc.shape
    if out.device.type != "cuda":
        raise ValueError(f"paged_decode_combine runs on cuda, not {out.device}")
    if ml.shape != (n, h, ns, 2) or out.shape != (n, 1, h, d) or ctx_lens.shape != (n,):
        raise ValueError("paged decode combine: ml [N, H, n_splits, 2], acc [N, H, n_splits, "
                         "D], out [N, 1, H, D] and ctx_lens [N]")
    if ctx_lens.dtype != torch.int32 or out.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError("ctx_lens must be int32 and out float32/bfloat16/float16")
    cuda_build.check_cuda(dict(ml=ml, acc=acc), torch.float32, out.device)
    cuda_build.check_cuda(dict(ctx_lens=ctx_lens, out=out), out.dtype, out.device)
    if n == 0:
        return out
    fn = cuda_build.kernel_fn("paged_decode", "ttpu_paged_decode_combine", _COMBINE_ARGTYPES)
    code = fn(ctx_lens.data_ptr(), ml.data_ptr(), acc.data_ptr(), out.data_ptr(), n, h, d,
              max_slots, int(sliding_window or 0), split_slots, ns,
              cuda_build.DTYPE_CODES[out.dtype], cuda_build.stream_ptr(out.device))
    cuda_build.raise_on_error(code, "paged_decode_combine")
    paged_decode_combine.launches += 1
    return out


def _paged_decode_cuda(q, k_pool, v_pool, block_tables, ctx_lens, *, scale, sliding_window):
    n, _, h, d = q.shape
    p, kvh, bs = k_pool.shape[:3]
    maxb = block_tables.shape[1]
    if q.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"paged decode kernel takes float32/bfloat16/float16, got {q.dtype}")
    if not paged_decode_supported(q, k_pool):
        raise ValueError(f"paged decode kernel shapes: q {tuple(q.shape)} "
                         f"pool {tuple(k_pool.shape)}")
    if k_pool.shape != (p, kvh, bs, d) or v_pool.shape != k_pool.shape:
        raise ValueError("paged decode: pools must both be [P, KVH, BS, D]")
    if block_tables.shape != (n, maxb) or ctx_lens.shape != (n,):
        raise ValueError("block_tables must be [N, MAXB] and ctx_lens [N]")
    if block_tables.dtype != torch.int32 or ctx_lens.dtype != torch.int32:
        raise ValueError("block_tables and ctx_lens must be int32")
    split = split_size(bs)
    if split // bs > MAX_SPLIT_PAGES:
        raise ValueError(f"paged decode: a split of {split} slots spans more than "
                         f"{MAX_SPLIT_PAGES} pages of {bs}")
    cuda_build.check_cuda(dict(q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables,
                               ctx_lens=ctx_lens), q.dtype, q.device)
    out = torch.empty_like(q)
    if n == 0:
        return out
    ns = -(-maxb * bs // split)
    # one scratch buffer: the partials' acc [N, H, n_splits, D], then ml [N, H, n_splits, 2]
    # (D floats a row keep ml 16-byte aligned)
    scratch = torch.empty(n * h * ns * (d + 2), dtype=torch.float32, device=q.device)
    acc_ptr = scratch.data_ptr()
    fn = cuda_build.kernel_fn("paged_decode", "ttpu_paged_decode", _ARGTYPES)
    code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
              ctx_lens.data_ptr(), out.data_ptr(), acc_ptr + n * h * ns * d * 4, acc_ptr, n, h,
              kvh, bs, d, maxb, int(sliding_window or 0), float(scale), split, ns,
              cuda_build.DTYPE_CODES[q.dtype], cuda_build.stream_ptr(q.device))
    cuda_build.raise_on_error(code, "paged_decode")
    # one call launched both kernels: the split pass and the merge
    paged_decode_attention.launches += 1
    paged_decode_combine.launches += 1
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, ctx_lens, *, scale: float,
                           sliding_window: Optional[int] = None):
    """One decode step over paged K/V. q [N, 1, H, D]; pools [P, KVH, BS, D];
    ``block_tables`` [N, MAXB] page ids; ``ctx_lens`` [N] live slots per row,
    this step's token included. Returns the attention output [N, 1, H, D].
    Not differentiable: raises when a gradient would be needed."""
    cuda_build.refuse_grad("paged_decode_attention", q, k_pool, v_pool)
    args = (q.contiguous(), k_pool, v_pool, block_tables.to(torch.int32).contiguous(),
            ctx_lens.to(torch.int32).contiguous())
    kw = dict(scale=float(scale), sliding_window=sliding_window)
    if q.device.type == "cuda":
        return _paged_decode_cuda(*args, **kw)
    if q.device.type == "cpu":
        return paged_decode_plain(*args, **kw)
    raise ValueError(f"paged_decode_attention runs on cuda or cpu, not {q.device}")


cuda_build.counted(paged_decode_attention)
cuda_build.counted(paged_decode_combine)
