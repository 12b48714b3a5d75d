"""Attention registry and the eager (plain PyTorch) implementations.

Port of ``transformers_tpu/ops/attention.py``. Every implementation takes
the BSHD layout (batch, seq, heads, head_dim), GQA k/v with fewer heads
directly, and the mask as data (q_positions + kv_valid + flags); only the
eager path renders a bias tensor.

Keys of ``ALL_ATTENTION_FUNCTIONS``:
- ``eager`` (``sdpa`` is an alias): the plain path, f32 softmax.
- ``flash``, ``flash_attention_2``, ``flash_attention_3``, ``default``: the
  flash kernel (ops/flash_attention.py) for the masks and shapes it takes,
  else eager.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import flash_attention, flash_supported
from .masks import causal_mask_bool, to_additive


def _render_bias(q, k, q_positions, kv_valid, is_causal, sliding_window, q_segment_ids=None,
                 kv_segment_ids=None):
    b, sq = q.shape[0], q.shape[1]
    skv = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.int32, device=q.device)
    if is_causal:
        mask = causal_mask_bool(q_positions, kv_valid, sliding_window=sliding_window,
                                q_segment_ids=q_segment_ids, kv_segment_ids=kv_segment_ids)
    else:
        mask = (kv_valid != 0)[:, None, None, :].expand(b, 1, sq, skv)
        if sliding_window is not None:
            # bidirectional window, inclusive distance
            kv_pos = torch.arange(skv, device=q.device)[None, None, None, :]
            dist = (q_positions.to(torch.int64)[:, None, :, None] - kv_pos).abs()
            mask = mask & (dist <= sliding_window)
    return to_additive(mask, torch.float32)


def _softmax_with_sinks(scores, sinks, kvh, g):
    """Softmax whose denominator also holds a learned per-head sink logit; the
    sink's probability mass is dropped."""
    b, _, _, sq, _ = scores.shape
    sink = sinks.float().reshape(kvh, g)[None, :, :, None, None].expand(b, kvh, g, sq, 1)
    return torch.softmax(torch.cat([scores, sink], dim=-1), dim=-1)[..., :-1]


def eager_attention(
    q: torch.Tensor,  # [B, Q, H, D]
    k: torch.Tensor,  # [B, KV, KVH, D]
    v: torch.Tensor,  # [B, KV, KVH, D]
    bias: Optional[torch.Tensor] = None,  # [B, 1|H, Q, KV] additive; built from the mask data when absent
    *,
    q_positions: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    is_causal: bool = True,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    probs_sink: Optional[list] = None,
    sinks: Optional[torch.Tensor] = None,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    **kwargs,
) -> torch.Tensor:
    """Dot-product attention with an f32 softmax; GQA as a grouped einsum (K/V
    are never replicated). With ``probs_sink`` (the ``output_attentions``
    channel), the [B, H, Q, KV] probabilities are appended to it in q's dtype."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    g = h // kvh
    if bias is None:
        bias = _render_bias(q, k, q_positions, kv_valid, is_causal, sliding_window,
                            q_segment_ids, kv_segment_ids)
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, sq, kvh, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if logit_cap is not None and logit_cap > 0:
        scores = logit_cap * torch.tanh(scores / logit_cap)
    bias32 = bias.float()
    if bias32.shape[1] == 1:
        bias32 = bias32[:, :, None]
    else:
        bias32 = bias32.reshape(b, kvh, g, *bias32.shape[-2:])
    scores = scores + bias32
    if sinks is not None:
        probs = _softmax_with_sinks(scores, sinks, kvh, g)
    else:
        probs = torch.softmax(scores, dim=-1)
    if probs_sink is not None:
        probs_sink.append(probs.to(q.dtype).reshape(b, h, sq, -1))
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    # v may be narrower than q/k (MLA: v_head_dim != qk_head_dim)
    return out.reshape(b, sq, h, v.shape[-1])


def cached_attention_bhsd(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, KVH, S, D] (bhsd cache buffer)
    v: torch.Tensor,  # [B, KVH, S, D]
    *,
    q_positions: Optional[torch.Tensor] = None,  # [B, Sq] absolute slots
    kv_valid: Optional[torch.Tensor] = None,  # [B, S]
    is_causal: bool = True,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
    logit_cap: Optional[float] = None,
    probs_sink: Optional[list] = None,
    sinks: Optional[torch.Tensor] = None,
    **kwargs,
) -> torch.Tensor:
    """Attention over a [B, KVH, S, D] cache: the unfused decode path (and any
    Sq > 1 over a filled cache). Same semantics as ``eager_attention``."""
    b, sq, h, d = q.shape
    kvh, skv = k.shape[1], k.shape[2]
    g = h // kvh
    scale = scale if scale is not None else d ** -0.5
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.int32, device=q.device)

    qg = q.reshape(b, sq, kvh, g, d)
    scores = torch.einsum("bqhgd,bhsd->bhgqs", qg.float(), k.float()) * scale
    if logit_cap is not None and logit_cap > 0:
        scores = logit_cap * torch.tanh(scores / logit_cap)

    kv_pos = torch.arange(skv, device=q.device)[None, None, :]  # slot index == position
    qp = q_positions.to(torch.int64)[:, :, None]
    valid = (kv_valid != 0)[:, None, :]
    if is_causal:
        visible = valid & (kv_pos <= qp)
        if sliding_window is not None:
            visible = visible & (kv_pos > qp - sliding_window)
    else:
        visible = valid.expand(b, sq, skv)
        if sliding_window is not None:
            visible = visible & ((qp - kv_pos).abs() <= sliding_window)
    scores = scores.masked_fill(~visible[:, None, None], torch.finfo(torch.float32).min)

    if sinks is not None:
        probs = _softmax_with_sinks(scores, sinks, kvh, g)
    else:
        probs = torch.softmax(scores, dim=-1)
    if probs_sink is not None:
        probs_sink.append(probs.to(q.dtype).reshape(b, h, sq, skv))
    out = torch.einsum("bhgqs,bhsd->bhgqd", probs.to(v.dtype), v)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, v.shape[-1])


def flash_attention_dispatch(q, k, v, bias=None, *, q_positions=None, kv_valid=None,
                             is_causal=True, sliding_window=None, scale=None, logit_cap=None,
                             probs_sink=None, sinks=None, **kwargs):
    """The flash kernel for the masks and shapes it takes, else eager.
    ``output_attentions`` (a ``probs_sink``) takes the eager path: flash never
    materialises the probabilities."""
    bidir_window = (not is_causal) and sliding_window is not None
    if (probs_sink is None and bias is None and sinks is None
            and kwargs.get("q_segment_ids") is None
            and not bidir_window and flash_supported(q, k, v)):
        return flash_attention(q, k, v, q_positions=q_positions, kv_valid=kv_valid, scale=scale,
                               logit_cap=logit_cap, is_causal=is_causal,
                               sliding_window=sliding_window)
    return eager_attention(q, k, v, bias, q_positions=q_positions, kv_valid=kv_valid,
                           is_causal=is_causal, sliding_window=sliding_window, scale=scale,
                           logit_cap=logit_cap, probs_sink=probs_sink, sinks=sinks, **kwargs)


ALL_ATTENTION_FUNCTIONS = {
    "eager": eager_attention,
    "sdpa": eager_attention,
    "flash": flash_attention_dispatch,
    "flash_attention_2": flash_attention_dispatch,
    "flash_attention_3": flash_attention_dispatch,
    "default": flash_attention_dispatch,
}


def get_attention_fn(implementation: Optional[str]):
    key = implementation or "default"
    if key not in ALL_ATTENTION_FUNCTIONS:
        raise KeyError(f"Unknown attention implementation {key!r}; "
                       f"valid: {sorted(ALL_ATTENTION_FUNCTIONS)}")
    return ALL_ATTENTION_FUNCTIONS[key]
