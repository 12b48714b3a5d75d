"""Flash attention forward (prefill) for the H100: ``csrc/flash_fwd.cu``.

Replaces the TPU kernel ``transformers_tpu/ops/pallas/flash_attention.py``
(``_flash_fwd`` / ``_flash_kernel``, public entry ``flash_attention``).
Layout BSHD, mask as data: ``q_positions [B, Sq]`` is the absolute slot of
each query row and ``kv_valid [B, Skv]`` marks live kv slots. Query i sees
slot j iff ``kv_valid[j]`` and, when causal, ``j <= q_positions[i]``, and,
with a window, ``j > q_positions[i] - window``; a tanh softcap bounds the
scores first. GQA reads kv head ``h // (H // KVH)``.

Semantics that differ from the Pallas kernel: a query row that sees no slot
gives 0 and a logsumexp of -inf. Such rows are left-pad rows only; no valid
row reads them.

What bounds it on the card, and what the design does about it: see the
note at the top of ``csrc/flash_fwd.cu``.

The wrapper takes a CUDA tensor to the kernel and a CPU tensor to the plain
PyTorch version below, and nothing else: there is no fallback. It counts
its kernel launches in ``flash_attention.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

KERNEL_HEAD_DIMS = (64, 128, 256)
# ttpu_flash_fwd(q, k, v, q_positions, kv_valid, out, lse, B, Sq, Skv, H, KVH, D,
#                scale, causal, window, logit_cap, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def flash_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Shapes the kernel takes; other shapes use the eager path."""
    h, d = q.shape[2], q.shape[3]
    return h % k.shape[2] == 0 and v.shape[-1] == d and d in KERNEL_HEAD_DIMS


def flash_attention_plain(q, k, v, q_positions, kv_valid, *, scale: float,
                          is_causal: bool = True, sliding_window: Optional[int] = None,
                          logit_cap: Optional[float] = None):
    """Plain PyTorch version of the kernel: f32 scores and softmax, output cast to
    q's dtype. Returns (out [B, Sq, H, D], lse [B, H, Sq] f32)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, sq, kvh, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if logit_cap is not None and logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    slots = torch.arange(skv, device=q.device)[None, None, :]
    qp = q_positions.to(torch.int64)[:, :, None]
    visible = (kv_valid != 0)[:, None, :]
    if is_causal:
        visible = visible & (slots <= qp)
    if sliding_window is not None:
        visible = visible & (slots > qp - sliding_window)
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
    out = out.reshape(b, h, sq, d).transpose(1, 2).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def _flash_cuda(q, k, v, q_positions, kv_valid, *, scale, is_causal, sliding_window,
                logit_cap):
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if q.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"flash kernel takes float32/bfloat16/float16, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS or v.shape[-1] != d or h % kvh:
        raise ValueError(f"flash kernel shapes: q {tuple(q.shape)} k {tuple(k.shape)}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} do not match q")
    if q_positions.shape != (b, sq) or kv_valid.shape != (b, skv):
        raise ValueError("q_positions must be [B, Sq] and kv_valid [B, Skv]")
    if q_positions.dtype != torch.int32 or kv_valid.dtype != torch.int32:
        raise ValueError("q_positions and kv_valid must be int32")
    cuda_build.check_cuda(dict(q=q, k=k, v=v, q_positions=q_positions, kv_valid=kv_valid),
                          q.dtype, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = cuda_build.kernel_fn("flash_fwd", "ttpu_flash_fwd", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
              kv_valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
              b, sq, skv, h, kvh, d, float(scale), int(bool(is_causal)),
              int(sliding_window or 0), float(logit_cap or 0.0),
              cuda_build.DTYPE_CODES[q.dtype], cuda_build.stream_ptr(q.device))
    cuda_build.raise_on_error(code, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def flash_attention(q, k, v, *, q_positions=None, kv_valid=None, scale: Optional[float] = None,
                    is_causal: bool = True, sliding_window: Optional[int] = None,
                    logit_cap: Optional[float] = None, return_lse: bool = False):
    """Public entry (BSHD), the counterpart of the Pallas ``flash_attention``.
    Returns the output, or (output, lse [B, H, Sq] f32) with ``return_lse``."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32, device=q.device).expand(b, sq)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.int32, device=q.device)
    scale = float(scale) if scale is not None else d ** -0.5
    kw = dict(scale=scale, is_causal=is_causal, sliding_window=sliding_window,
              logit_cap=logit_cap)
    if q.device.type == "cuda":
        out, lse = _flash_cuda(q, k, v, q_positions.to(torch.int32).contiguous(),
                               kv_valid.to(torch.int32).contiguous(), **kw)
    elif q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, q_positions, kv_valid, **kw)
    else:
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return (out, lse) if return_lse else out


flash_attention.launches = 0
