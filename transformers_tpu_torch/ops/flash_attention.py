"""Flash attention for the H100: forward ``csrc/flash_fwd.cu`` (K1) and
backward ``csrc/flash_bwd.cu`` (K4 dK/dV, K5 dQ).

Replaces the TPU kernels of ``transformers_tpu/ops/pallas/flash_attention.py``
(``_flash_fwd`` / ``_flash_kernel``; ``_flash_bwd`` with
``_flash_bwd_dkv_kernel`` and ``_flash_bwd_dq_kernel``; public entry
``flash_attention``, differentiable through ``jax.custom_vjp``). Layout
BSHD, mask as data: ``q_positions [B, Sq]`` is the absolute slot of each
query row and ``kv_valid [B, Skv]`` marks live kv slots. Query i sees slot j
iff ``kv_valid[j]`` and, when causal, ``j <= q_positions[i]``, and, with a
window, ``j > q_positions[i] - window``; a tanh softcap bounds the scores
first. GQA reads kv head ``h // (H // KVH)``.

Semantics that differ from the Pallas kernel: a query row that sees no slot
gives 0 and a logsumexp of -inf, and gets zero gradients. Such rows are
left-pad rows only; no valid row reads them.

``flash_attention`` goes through ``FlashAttentionFunction``, whose backward
runs K5 then K4 (K5 also writes ``delta = rowsum(dO * O)``, which K4 reads).
K1's routes on the card, by storage type and head_dim: bf16/f16 at 64, 96
and 128 run ``mma.sync`` tensor-core tiles (``flash_fwd_tc_kernel``), at 256
``wgmma`` products fed by TMA (``flash_fwd_wg_kernel``); f32 runs CUDA-core
FMAs (``flash_fwd_kernel``) at every head_dim. Both tensor-core routes round
P once to the storage type before P.V, as the Pallas kernel does;
``flash_attention_tiled_plain`` is that computation at the kernel's kv tile,
which the card's checks hold the ``wgmma`` route to. K4/K5 route the same
way: ``mma.sync`` for bf16/f16 up to head_dim 128 (``*_tc_kernel``),
``wgmma`` fed by TMA at 256 (``*_wg_kernel``), CUDA-core FMAs in f32. What
bounds each kernel on the card, and what its design does about it: see the
notes at the top of the two ``.cu`` files.

Each wrapper takes a CUDA tensor to its kernel and a CPU tensor to the plain
PyTorch version beside it, and nothing else: there is no fallback. Launches
are counted in ``flash_attention.launches`` (K1), ``flash_bwd_dq.launches``
(K5) and ``flash_bwd_dkv.launches`` (K4).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

KERNEL_HEAD_DIMS = (64, 96, 128, 256)  # K1, K4 and K5
# ttpu_flash_fwd(q, k, v, q_positions, kv_valid, out, lse, B, Sq, Skv, H, KVH, D,
#                scale, causal, window, logit_cap, dtype, stream)
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p)
# ttpu_flash_bwd_dq / ttpu_flash_bwd_dkv(10 pointers, B, Sq, Skv, H, KVH, D, scale, causal,
#                                        window, logit_cap, dtype, stream)
_BWD_ARGTYPES = (ctypes.c_void_p,) * 10 + _ARGTYPES[7:]


def flash_supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Shapes the kernels take; other shapes use the eager path."""
    h, d = q.shape[2], q.shape[3]
    return h % k.shape[2] == 0 and v.shape[-1] == d and d in KERNEL_HEAD_DIMS


def _visible(q_positions, kv_valid, skv: int, is_causal: bool,
             sliding_window: Optional[int]) -> torch.Tensor:
    """[B, Sq, Skv] bool: which kv slots each query row sees."""
    slots = torch.arange(skv, device=kv_valid.device)[None, None, :]
    qp = q_positions.to(torch.int64)[:, :, None]
    visible = (kv_valid != 0)[:, None, :]
    if is_causal:
        visible = visible & (slots <= qp)
    if sliding_window:
        visible = visible & (slots > qp - sliding_window)
    return visible


def _capped(s, logit_cap):
    return logit_cap * torch.tanh(s / logit_cap) if logit_cap else s


def flash_attention_plain(q, k, v, q_positions, kv_valid, *, scale: float,
                          is_causal: bool = True, sliding_window: Optional[int] = None,
                          logit_cap: Optional[float] = None):
    """Plain PyTorch version of K1: f32 scores and softmax, output cast to
    q's dtype. Returns (out [B, Sq, H, D], lse [B, H, Sq] f32)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, sq, kvh, g, d)
    s = _capped(torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale, logit_cap)
    visible = _visible(q_positions, kv_valid, skv, is_causal, sliding_window)
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float()) / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
    out = out.reshape(b, h, sq, d).transpose(1, 2).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def flash_attention_tiled_plain(q, k, v, q_positions, kv_valid, *, scale: float,
                                is_causal: bool = True, sliding_window: Optional[int] = None,
                                logit_cap: Optional[float] = None, block_kv: int = 64):
    """K1's tiling as plain PyTorch: an online softmax over ``block_kv``-slot
    tiles (tile t holds slots [t * block_kv, (t + 1) * block_kv)). A tile that
    a row cannot see leaves its max, sum and output exactly as they were, so
    the tiles the kernel skips need no skipping here. P is rounded once to
    v's dtype before P.V, as the Pallas ``_flash_kernel`` (``p.astype(v.dtype)``)
    and the bf16/f16 kernels round it; the row sums add the f32 P. Nothing on
    the main path calls it: the kernel is held to it on the card. Returns
    (out [B, Sq, H, D] in q's dtype, lse [B, H, Sq] f32); a row that sees no
    slot gives 0 and -inf."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, sq, kvh, g, d)
    kf, vf = k.float(), v.float()
    visible = _visible(q_positions, kv_valid, skv, is_causal, sliding_window)  # [B, Sq, Skv]

    neg_inf = float("-inf")
    m = torch.full((b, kvh, g, sq), neg_inf, device=q.device)
    l = torch.zeros((b, kvh, g, sq), device=q.device)
    acc = torch.zeros((b, kvh, g, sq, d), device=q.device)
    for kv0 in range(0, skv, block_kv):
        kv1 = min(kv0 + block_kv, skv)
        s = _capped(torch.einsum("bqhgd,bkhd->bhgqk", qg, kf[:, kv0:kv1]) * scale, logit_cap)
        s = s.masked_fill(~visible[:, None, None, :, kv0:kv1], neg_inf)
        m_new = torch.maximum(m, s.amax(-1))
        dead = torch.isneginf(m_new)  # nothing visible to the row yet
        alpha = torch.where(dead, 1.0, torch.exp(m - m_new))
        p = torch.where(dead[..., None], 0.0, torch.exp(s - m_new[..., None]))
        l = l * alpha + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), vf[:, kv0:kv1])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.where(l > 0, l, 1.0)[..., None]
    lse = torch.where(l > 0, m + torch.log(torch.where(l > 0, l, 1.0)), neg_inf)
    out = out.reshape(b, h, sq, d).transpose(1, 2).to(q.dtype)
    return out, lse.reshape(b, h, sq)


def _p_ds_plain(q, k, v, do, lse, delta, q_positions, kv_valid, *, scale, is_causal,
                sliding_window, logit_cap):
    """The backward's recompute in f32, as the Pallas ``_recompute_p_ds``:
    (q, dO as [B, Sq, KVH, G, D], p, ds as [B, KVH, G, Sq, Skv]). exp is taken
    only where the mask holds, so p is exactly 0 elsewhere."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.float().reshape(b, sq, kvh, g, d)
    dog = do.float().reshape(b, sq, kvh, g, d)
    sc = _capped(torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale, logit_cap)
    visible = _visible(q_positions, kv_valid, skv, is_causal, sliding_window)[:, None, None]
    lse = lse.reshape(b, kvh, g, sq, 1)
    p = torch.exp(torch.where(visible & torch.isfinite(lse), sc - lse, float("-inf")))
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.reshape(b, kvh, g, sq, 1))
    if logit_cap:
        ds = ds * (1.0 - (sc / logit_cap) ** 2)
    return qg, dog, p, ds * scale


def flash_bwd_dq_plain(q, k, v, out, do, lse, q_positions, kv_valid, *, scale: float,
                       is_causal: bool = True, sliding_window: Optional[int] = None,
                       logit_cap: Optional[float] = None):
    """Plain PyTorch version of K5. Returns (dq in q's dtype, delta [B, H, Sq] f32)."""
    b, sq, h, d = q.shape
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2)
    *_, ds = _p_ds_plain(q, k, v, do, lse, delta, q_positions, kv_valid, scale=scale,
                         is_causal=is_causal, sliding_window=sliding_window, logit_cap=logit_cap)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()).reshape(b, sq, h, d)
    return dq.to(q.dtype), delta.contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_positions, kv_valid, *, scale: float,
                        is_causal: bool = True, sliding_window: Optional[int] = None,
                        logit_cap: Optional[float] = None):
    """Plain PyTorch version of K4: (dk, dv) in k's and v's dtype, summed over
    each kv head's group of query heads."""
    qg, dog, p, ds = _p_ds_plain(q, k, v, do, lse, delta, q_positions, kv_valid, scale=scale,
                                 is_causal=is_causal, sliding_window=sliding_window,
                                 logit_cap=logit_cap)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qg)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, q_positions, kv_valid, out, lse, do, *, scale: float,
                              is_causal: bool = True, sliding_window: Optional[int] = None,
                              logit_cap: Optional[float] = None):
    """Plain PyTorch backward (K5 then K4): (dq, dk, dv), each in its input's dtype."""
    kw = dict(scale=scale, is_causal=is_causal, sliding_window=sliding_window,
              logit_cap=logit_cap)
    dq, delta = flash_bwd_dq_plain(q, k, v, out, do, lse, q_positions, kv_valid, **kw)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_positions, kv_valid, **kw)
    return dq, dk, dv


def _check_shapes(q, k, v, q_positions, kv_valid) -> None:
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if q.dtype not in cuda_build.DTYPE_CODES:
        raise ValueError(f"flash kernels take float32/bfloat16/float16, got {q.dtype}")
    if d not in KERNEL_HEAD_DIMS or v.shape[-1] != d or h % kvh:
        raise ValueError(f"flash kernel shapes: q {tuple(q.shape)} k {tuple(k.shape)}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)} / {tuple(v.shape)} do not match q")
    if q_positions.shape != (b, sq) or kv_valid.shape != (b, skv):
        raise ValueError("q_positions must be [B, Sq] and kv_valid [B, Skv]")
    if q_positions.dtype != torch.int32 or kv_valid.dtype != torch.int32:
        raise ValueError("q_positions and kv_valid must be int32")


def _launch_args(q, k, scale, is_causal, sliding_window, logit_cap) -> tuple:
    b, sq, h, d = q.shape
    return (b, sq, k.shape[1], h, k.shape[2], d, float(scale), int(bool(is_causal)),
            int(sliding_window or 0), float(logit_cap or 0.0), cuda_build.DTYPE_CODES[q.dtype],
            cuda_build.stream_ptr(q.device))


def _flash_cuda(q, k, v, q_positions, kv_valid, *, scale, is_causal, sliding_window,
                logit_cap):
    _check_shapes(q, k, v, q_positions, kv_valid)
    cuda_build.check_cuda(dict(q=q, k=k, v=v, q_positions=q_positions, kv_valid=kv_valid),
                          q.dtype, q.device)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = cuda_build.kernel_fn("flash_fwd", "ttpu_flash_fwd", _ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_positions.data_ptr(),
              kv_valid.data_ptr(), out.data_ptr(), lse.data_ptr(),
              *_launch_args(q, k, scale, is_causal, sliding_window, logit_cap))
    cuda_build.raise_on_error(code, "flash_fwd")
    flash_attention.launches += 1
    return out, lse


def _check_bwd_cuda(q, k, v, q_positions, kv_valid, like_q: dict, stats: dict) -> None:
    """``like_q``: tensors of q's shape and dtype; ``stats``: f32 [B, H, Sq]."""
    _check_shapes(q, k, v, q_positions, kv_valid)
    cuda_build.check_cuda(dict(q=q, k=k, v=v, q_positions=q_positions, kv_valid=kv_valid,
                               **like_q), q.dtype, q.device)
    cuda_build.check_cuda(stats, torch.float32, q.device)
    b, sq, h, _ = q.shape
    for name, t in like_q.items():
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(q.shape)}")
    for name, t in stats.items():
        if t.shape != (b, h, sq):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(b, h, sq)}")


def flash_bwd_dq(q, k, v, out, do, lse, q_positions, kv_valid, *, scale: float,
                 is_causal: bool = True, sliding_window: Optional[int] = None,
                 logit_cap: Optional[float] = None):
    """K5: dQ [B, Sq, H, D] in q's dtype and delta = rowsum(dO * O) [B, H, Sq]
    f32. ``out`` is the forward's output, ``lse`` its logsumexp [B, H, Sq]."""
    kw = dict(scale=scale, is_causal=is_causal, sliding_window=sliding_window,
              logit_cap=logit_cap)
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, out, do, lse, q_positions, kv_valid, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dq runs on cuda or cpu, not {q.device}")
    _check_bwd_cuda(q, k, v, q_positions, kv_valid, dict(out=out, do=do), dict(lse=lse))
    dq = torch.empty_like(q)
    delta = torch.empty_like(lse)
    fn = cuda_build.kernel_fn("flash_bwd", "ttpu_flash_bwd_dq", _BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), do.data_ptr(),
              lse.data_ptr(), q_positions.data_ptr(), kv_valid.data_ptr(), dq.data_ptr(),
              delta.data_ptr(), *_launch_args(q, k, **kw))
    cuda_build.raise_on_error(code, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq, delta


def flash_bwd_dkv(q, k, v, do, lse, delta, q_positions, kv_valid, *, scale: float,
                  is_causal: bool = True, sliding_window: Optional[int] = None,
                  logit_cap: Optional[float] = None):
    """K4: (dK, dV) [B, Skv, KVH, D] in k's dtype, summed over each kv head's
    group; ``delta`` is K5's."""
    kw = dict(scale=scale, is_causal=is_causal, sliding_window=sliding_window,
              logit_cap=logit_cap)
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, q_positions, kv_valid, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_bwd_dkv runs on cuda or cpu, not {q.device}")
    _check_bwd_cuda(q, k, v, q_positions, kv_valid, dict(do=do),
                    dict(lse=lse, delta=delta))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = cuda_build.kernel_fn("flash_bwd", "ttpu_flash_bwd_dkv", _BWD_ARGTYPES)
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
              delta.data_ptr(), q_positions.data_ptr(), kv_valid.data_ptr(), dk.data_ptr(),
              dv.data_ptr(), *_launch_args(q, k, **kw))
    cuda_build.raise_on_error(code, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


class FlashAttentionFunction(torch.autograd.Function):
    """K1 forward, K5 + K4 backward (the counterpart of the Pallas
    ``custom_vjp``). Saves q, k, v, the output and the logsumexp; the
    logsumexp output is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, q_positions, kv_valid, scale, is_causal, sliding_window,
                logit_cap):
        kw = dict(scale=scale, is_causal=is_causal, sliding_window=sliding_window,
                  logit_cap=logit_cap)
        if q.device.type == "cuda":
            out, lse = _flash_cuda(q, k, v, q_positions, kv_valid, **kw)
        elif q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, q_positions, kv_valid, **kw)
        else:
            raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
        ctx.save_for_backward(q, k, v, q_positions, kv_valid, out, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, q_positions, kv_valid, out, lse = ctx.saved_tensors
        do = dout.contiguous()  # autograd may hand in a strided gradient
        dq, delta = flash_bwd_dq(q, k, v, out, do, lse, q_positions, kv_valid, **ctx.kw)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, q_positions, kv_valid, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, *, q_positions=None, kv_valid=None, scale: Optional[float] = None,
                    is_causal: bool = True, sliding_window: Optional[int] = None,
                    logit_cap: Optional[float] = None, return_lse: bool = False):
    """Public entry (BSHD), the counterpart of the Pallas ``flash_attention``,
    differentiable in q, k and v. Returns the output, or (output, lse [B, H,
    Sq] f32) with ``return_lse``."""
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32, device=q.device).expand(b, sq)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.int32, device=q.device)
    if q.device.type == "cuda":
        q_positions = q_positions.to(torch.int32).contiguous()
        kv_valid = kv_valid.to(torch.int32).contiguous()
    scale = float(scale) if scale is not None else d ** -0.5
    out, lse = FlashAttentionFunction.apply(q, k, v, q_positions, kv_valid, scale, is_causal,
                                            sliding_window, logit_cap)
    return (out, lse) if return_lse else out


cuda_build.counted(flash_attention)
cuda_build.counted(flash_bwd_dq)
cuda_build.counted(flash_bwd_dkv)
