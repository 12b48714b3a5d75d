"""Attention masks as data.

Port of ``transformers_tpu/ops/masks.py``: masks are computed from integer
position and validity tensors and handed to kernels as those tensors
(q_positions + kv_valid) or, on the eager path only, rendered as an
additive float bias. Generation left-pads, so every row's next-token slot
is the same index.
"""

from __future__ import annotations

from typing import Optional

import torch


def min_value(dtype: torch.dtype) -> float:
    return float(torch.finfo(dtype).min)


def causal_mask_bool(
    q_positions: torch.Tensor,  # [B, Q] absolute slot of each query
    kv_valid: torch.Tensor,  # [B, KV] 1 where the kv slot holds a real token
    *,
    sliding_window: Optional[int] = None,
    q_segment_ids: Optional[torch.Tensor] = None,  # [B, Q] packed-sequence ids
    kv_segment_ids: Optional[torch.Tensor] = None,  # [B, KV]
) -> torch.Tensor:
    """Boolean mask [B, 1, Q, KV]: query at slot p sees kv slot s iff s <= p,
    the slot is valid, (optionally) p - s < sliding_window, and both are in
    the same packed segment."""
    kv = kv_valid.shape[-1]
    kv_pos = torch.arange(kv, device=kv_valid.device)[None, None, None, :]
    q_pos = q_positions.to(torch.int64)[:, None, :, None]
    allowed = kv_pos <= q_pos
    if sliding_window is not None:
        allowed = allowed & (kv_pos > q_pos - sliding_window)
    if q_segment_ids is not None and kv_segment_ids is not None:
        allowed = allowed & (q_segment_ids[:, None, :, None] == kv_segment_ids[:, None, None, :])
    return allowed & (kv_valid != 0)[:, None, None, :]


def to_additive(mask_bool: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bool -> additive bias; fully masked rows stay finite (no NaN softmax)."""
    zero = torch.zeros((), dtype=dtype, device=mask_bool.device)
    neg = torch.full((), min_value(dtype) / 2.0, dtype=dtype, device=mask_bool.device)
    return torch.where(mask_bool, zero, neg)


def segment_ids_from_position_ids(position_ids: torch.Tensor) -> torch.Tensor:
    """Packed-row segment ids from position resets: a new sequence starts
    wherever the position does not increment by one. A plain arange gives a
    single segment."""
    pos = position_ids.to(torch.int64)
    prev = torch.cat([torch.full_like(pos[..., :1], -2), pos[..., :-1]], dim=-1)
    return (pos != prev + 1).to(torch.int64).cumsum(-1) - 1
