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
CUDA kernel reads live pages only and keeps P.V in f32. What bounds it on the
card, and what the design does about it: see the note at the top of
``csrc/paged_decode.cu``.

The wrapper takes CUDA tensors to the kernel and CPU tensors to the plain
PyTorch version below, and nothing else: there is no fallback. It counts its
kernel launches in ``paged_decode_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

KERNEL_HEAD_DIMS = (64, 128, 256)
# ttpu_paged_decode(q, k_pool, v_pool, block_tables, ctx_lens, out,
#                   N, H, KVH, BS, D, MAXB, window, scale, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def paged_decode_supported(q: torch.Tensor, k_pool: torch.Tensor) -> bool:
    """Shapes the kernel takes; other shapes use the gather path."""
    h, d = q.shape[2], q.shape[3]
    return q.shape[1] == 1 and h % k_pool.shape[1] == 0 and d in KERNEL_HEAD_DIMS


def paged_decode_plain(q, k_pool, v_pool, block_tables, ctx_lens, *, scale: float,
                       sliding_window: Optional[int] = None):
    """Plain PyTorch version of the kernel, with the same rounding points: f32
    scores, softmax and P.V over the gathered pages, one cast to q's dtype.
    Returns [N, 1, H, D]."""
    n, _, h, d = q.shape
    kvh, bs = k_pool.shape[1], k_pool.shape[2]
    g = h // kvh
    slots = block_tables.shape[1] * bs

    def gather(pool):  # [N, MAXB, KVH, BS, D] -> [N, KVH, MAXB * BS, D]
        pages = pool[block_tables.long()].float()
        return pages.permute(0, 2, 1, 3, 4).reshape(n, kvh, slots, d)

    qg = q[:, 0].float().reshape(n, kvh, g, d)
    s = torch.einsum("nhgd,nhsd->nhgs", qg, gather(k_pool)) * scale
    ctx = ctx_lens.long()[:, None]
    j = torch.arange(slots, device=q.device)[None, :]
    live = j < ctx
    if sliding_window is not None:
        live = live & (j >= ctx - sliding_window)
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("nhgs,nhsd->nhgd", p, gather(v_pool)) / torch.where(l > 0, l, 1.0)
    return out.reshape(n, 1, h, d).to(q.dtype)


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
    cuda_build.check_cuda(dict(q=q, k_pool=k_pool, v_pool=v_pool, block_tables=block_tables,
                               ctx_lens=ctx_lens), q.dtype, q.device)
    out = torch.empty_like(q)
    if n == 0:
        return out
    fn = cuda_build.kernel_fn("paged_decode", "ttpu_paged_decode", _ARGTYPES)
    code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(),
              ctx_lens.data_ptr(), out.data_ptr(), n, h, kvh, bs, d, maxb,
              int(sliding_window or 0), float(scale), cuda_build.DTYPE_CODES[q.dtype],
              cuda_build.stream_ptr(q.device))
    cuda_build.raise_on_error(code, "paged_decode")
    paged_decode_attention.launches += 1
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


paged_decode_attention.launches = 0
