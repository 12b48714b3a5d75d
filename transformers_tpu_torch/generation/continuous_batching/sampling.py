"""The device sampler of continuous batching, shared by every decode path.

The JAX engine draws the m-th sampled token of a request with
``fold_in(key(seed), m)`` (continuous_api.py ``_sample``, model_runner.py
``decode_multi``), so a request's tokens depend on nothing co-scheduled and
are the same whether the engine syncs every step or every K steps. torch
cannot reproduce ``jax.random``; this sampler keeps the property with its own
counter-based draw: Gumbel-max, ``argmax(logits / T + g)``, where the noise
``g`` of row ``n`` at vocab index ``v`` is a function of ``(seed[n],
count[n], v)`` alone, computed by an integer hash in int64 tensor ops on the
device. Sampled tokens are therefore reproducible within the port but not
equal to the JAX package's. Greedy rows (temperature 0) take the argmax.
Top-k and top-p filter the tempered logits first, as the JAX host sampler
does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for x in [0, 2^32) and a 32-bit constant c, with every
    intermediate below 2^49 so int64 never overflows."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (lowbias32) on int64 tensors holding 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def gumbel_noise(seed: torch.Tensor, count: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [N, vocab] in f32, a pure function of (seed, count,
    vocab index) per element."""
    key = _hash32(_hash32(seed.long() & _M32) ^ (count.long() & _M32))
    v = torch.arange(vocab, dtype=torch.int64, device=seed.device)
    h = _hash32(_hash32(key[:, None] ^ v[None, :]) ^ 0x9E3779B9)
    u = ((h >> 8).float() + 0.5) * (1.0 / (1 << 24))  # uniform in (0, 1)
    return -torch.log(-torch.log(u))


@dataclass
class RowSampling:
    """Per-row sampling parameters as device tensors ([N] each)."""

    temperature: torch.Tensor  # f32, 0 = greedy
    top_k: torch.Tensor        # int64, 0 = off
    top_p: torch.Tensor        # f32, 1 = off
    seed: torch.Tensor         # int64
    count: torch.Tensor        # int64: tokens committed before this draw
    filtered: bool             # some row asks for top-k or top-p

    @classmethod
    def from_requests(cls, reqs: Sequence, counts: Sequence[int], device,
                      rows: Optional[int] = None) -> Optional["RowSampling"]:
        """Parameters of ``reqs`` (RequestState), padded to ``rows`` greedy
        rows; None when every request is greedy."""
        if all(not r.temperature or r.temperature <= 0 for r in reqs):
            return None
        pad = (rows or len(reqs)) - len(reqs)
        temps = [max(float(r.temperature or 0.0), 0.0) for r in reqs] + [0.0] * pad
        top_k = [int(r.top_k or 0) for r in reqs] + [0] * pad
        top_p = [float(r.top_p if r.top_p is not None else 1.0) for r in reqs] + [1.0] * pad
        packed = torch.tensor([temps, top_p], dtype=torch.float32)
        ints = torch.tensor([top_k, [int(r.seed) for r in reqs] + [0] * pad,
                             list(counts) + [0] * pad], dtype=torch.int64)
        packed, ints = packed.to(device), ints.to(device)
        return cls(temperature=packed[0], top_p=packed[1], top_k=ints[0], seed=ints[1],
                   count=ints[2], filtered=any(k > 0 for k in top_k) or any(
                       p < 1.0 for p in top_p))


def sample_tokens(logits: torch.Tensor, sampling: Optional[RowSampling],
                  count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Next token per row [N] (int64, on the device) from logits [N, V].
    ``count`` overrides ``sampling.count`` (the K-step loop advances it on
    the device)."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    if sampling is None:
        return greedy
    temp = sampling.temperature
    x = logits / temp.clamp_min(1e-6)[:, None]
    if sampling.filtered:
        srt = x.sort(dim=-1, descending=True).values
        k = sampling.top_k
        kth = srt.gather(1, (k - 1).clamp(0, x.shape[-1] - 1)[:, None])
        cut_k = (k > 0)[:, None]
        x = x.masked_fill(cut_k & (x < kth), float("-inf"))
        srt = srt.masked_fill(cut_k & (srt < kth), float("-inf"))
        probs = torch.softmax(srt, dim=-1)
        keep = (probs.cumsum(dim=-1) - probs) < sampling.top_p[:, None]
        last = srt.gather(1, (keep.sum(dim=-1) - 1).clamp_min(0)[:, None])
        x = x.masked_fill((sampling.top_p < 1.0)[:, None] & (x < last), float("-inf"))
    noise = gumbel_noise(sampling.seed, sampling.count if count is None else count,
                         x.shape[-1])
    sampled = (x + noise).argmax(dim=-1)
    return torch.where(temp > 0, sampled, greedy)
