"""Watermarking: the green-list processor and its detector, and SynthID-Text.

Port of ``transformers_tpu/generation/watermarking.py`` (reference
src/transformers/generation/watermarking.py and logits_process.py:2562),
computed in torch on the tensors' device.

The green list is the set of vocabulary ids whose keyed hash, seeded by the
previous token, falls below ``greenlist_ratio`` of 2**32: integer ops only
(no host draws), so the processor runs on the device like the others. The
hash is uint32 arithmetic; PyTorch's ``uint32`` has few CUDA kernels, so it
runs in int64 with every product and xor masked to its low 32 bits (exact
even where the int64 product wraps), which keeps every value non-negative,
so the shifts are logical and the threshold compare unsigned.

SynthID relies on int64 wraparound and on floor-mod (``torch.remainder``),
which torch computes as numpy does. Its sampling table comes from a CPU
``torch.Generator`` seeded with ``sampling_table_seed``, as the JAX package
and the reference build it, and is then moved to the device.
"""

from __future__ import annotations

import math

import torch

U32 = 0xFFFFFFFF


def _hash_mix(x: torch.Tensor, key: int) -> torch.Tensor:
    """The JAX package's uint32 integer hash, as int64 values in [0, 2**32)."""
    x = ((x.to(torch.int64) & U32) * ((key | 1) & U32)) & U32
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & U32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & U32
    return x ^ (x >> 16)


class WatermarkLogitsProcessor:
    """Green-list bias watermark (reference WatermarkLogitsProcessor), a
    ``(logits, state)`` processor: ``bias`` is added to the green list of the
    token before ``state["pos"]``."""

    def __init__(self, vocab_size: int, *, greenlist_ratio: float = 0.25,
                 bias: float = 2.0, hashing_key: int = 15485863,
                 seeding_scheme: str = "lefthash"):
        self.vocab_size = vocab_size
        self.greenlist_ratio = greenlist_ratio
        self.bias = bias
        self.hashing_key = hashing_key

    def greenlist_mask(self, prev_token: torch.Tensor) -> torch.Tensor:
        """[B] previous tokens -> [B, V] bool green mask."""
        vocab = torch.arange(self.vocab_size, dtype=torch.int64, device=prev_token.device)
        seed = _hash_mix(prev_token, self.hashing_key)[:, None]
        h = _hash_mix(vocab[None, :] ^ seed, self.hashing_key)
        return h < int(self.greenlist_ratio * float(2**32 - 1))

    def __call__(self, logits, state=None):
        if state is None or "ids" not in state:
            return logits
        ids = state["ids"]
        pos = torch.as_tensor(state["pos"], device=ids.device)
        prev = ids.gather(1, (pos - 1).clamp_min(0).reshape(1, 1).expand(ids.shape[0], 1))[:, 0]
        green = self.greenlist_mask(prev)[:, :logits.shape[-1]]
        return torch.where(green, logits + self.bias, logits)


class WatermarkDetector:
    """z-score detector over the green-token frequency (reference
    WatermarkDetector)."""

    def __init__(self, processor: WatermarkLogitsProcessor):
        self.processor = processor

    def score(self, sequences) -> dict:
        """``num_green`` and ``z_score`` [B], and ``prediction`` (z > 4), as
        tensors on the sequences' device."""
        seq = torch.as_tensor(sequences)
        if seq.ndim == 1:
            seq = seq[None]
        prev, cur = seq[:, :-1], seq[:, 1:]
        green = self.processor.greenlist_mask(prev.reshape(-1))
        hit = green.gather(1, cur.reshape(-1, 1).to(torch.int64))[:, 0].reshape(cur.shape)
        n = cur.shape[1]
        count = hit.sum(dim=1)
        p = self.processor.greenlist_ratio
        z = (count - n * p).to(torch.float32) / math.sqrt(n * p * (1 - p))
        return {"num_green": count, "z_score": z, "prediction": z > 4.0}


class SynthIDTextWatermarkLogitsProcessor:
    """SynthID-Text watermarking (reference logits_process.py:2562
    SynthIDTextWatermarkLogitsProcessor), tournament-free: per step, hash the
    (ngram_len - 1)-token context with each watermarking key (a linear
    congruential accumulate), look Bernoulli g-values up in a seeded sampling
    table, and tilt the token probabilities by ``p *= 1 + g - E[g]`` per key.
    Contexts seen within the last ``context_history_size`` calls are left
    unwatermarked, so detection stays calibrated.

    Stateful, ``(input_ids, scores)`` as in the reference: each call after the
    first shifts the last token of ``input_ids`` into the context."""

    def __init__(self, ngram_len: int, keys: list, sampling_table_size: int,
                 sampling_table_seed: int, context_history_size: int,
                 skip_first_ngram_calls: bool = False, debug_mode: bool = False,
                 device=None):
        self.ngram_len = ngram_len
        self.keys = torch.as_tensor(keys, dtype=torch.int64, device=device)
        gen = torch.Generator(device="cpu").manual_seed(sampling_table_seed)
        self.sampling_table = torch.randint(0, 2, (sampling_table_size,),
                                            generator=gen).to(device)
        self.context_history_size = context_history_size
        self.skip_first_ngram_calls = skip_first_ngram_calls
        self.debug_mode = debug_mode
        self.state = None

    # ------------------------------------------------------------- hashing
    @staticmethod
    def accumulate_hash(current_hash: torch.Tensor, data: torch.Tensor,
                        multiplier: int = 6364136223846793005,
                        increment: int = 1) -> torch.Tensor:
        """``h = (h + x) * multiplier + increment`` over the last dim of
        ``data``, in wrapping int64."""
        h = current_hash.to(torch.int64)
        mul = multiplier - (1 << 64) if multiplier > 2**63 - 1 else multiplier
        for i in range(data.shape[-1]):
            h = (h + data[..., i]) * mul + increment
        return h

    def compute_ngram_keys(self, ngrams: torch.Tensor) -> torch.Tensor:
        """[B, N, ngram_len] -> keys [B, N, depth]."""
        b, n, _ = ngrams.shape
        h = self.accumulate_hash(torch.ones((b, n), dtype=torch.int64, device=ngrams.device),
                                 ngrams)
        keys = self.keys.to(ngrams.device)[None, None, :, None].expand(b, n, -1, 1)
        return self.accumulate_hash(h[..., None], keys)

    def sample_g_values(self, ngram_keys: torch.Tensor) -> torch.Tensor:
        table = self.sampling_table.to(ngram_keys.device)
        return table[torch.remainder(ngram_keys, table.shape[0])]

    def compute_g_values(self, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, S] -> g values [B, S - ngram_len + 1, depth] (the detection side)."""
        ngrams = torch.as_tensor(input_ids).to(torch.int64).unfold(1, self.ngram_len, 1)
        return self.sample_g_values(self.compute_ngram_keys(ngrams))

    # -------------------------------------------------------------- scoring
    def update_scores(self, scores: torch.Tensor, g_values: torch.Tensor) -> torch.Tensor:
        """The tilt, in float64 from the first product with the integer g
        values on, as numpy promotes it in the JAX package."""
        probs = torch.softmax(scores.float(), dim=1).double()
        for i in range(g_values.shape[-1]):
            g = g_values[:, :, i].double()
            g_mass = (g * probs).sum(dim=1, keepdim=True)
            probs = probs * (1 + g - g_mass)
        logp = torch.log(probs)
        return torch.where(torch.isfinite(logp), logp,
                           torch.finfo(scores.dtype).min).to(scores.dtype)

    def __call__(self, input_ids, scores):
        input_ids = torch.as_tensor(input_ids).to(torch.int64)
        scores = torch.as_tensor(scores).float()
        b, vocab = scores.shape
        dev = scores.device
        if self.debug_mode:
            scores = torch.ones_like(scores)
        if self.state is None:
            self.state = {
                "context": torch.zeros((b, self.ngram_len - 1), dtype=torch.int64, device=dev),
                "history": torch.zeros((b, self.context_history_size), dtype=torch.int64,
                                       device=dev),
                "num_calls": 0,
            }
        else:
            self.state["context"] = torch.cat(
                [self.state["context"], input_ids[:, -1:].to(dev)], dim=1)[:, 1:]
        self.state["num_calls"] += 1
        if self.skip_first_ngram_calls and self.state["num_calls"] < self.ngram_len:
            return scores

        h_ctx = self.accumulate_hash(torch.ones(b, dtype=torch.int64, device=dev),
                                     self.state["context"])                      # [B]
        all_idx = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :].expand(b, vocab)
        h = self.accumulate_hash(h_ctx[:, None].expand(b, vocab), all_idx[..., None])  # [B, V]
        keys = self.keys.to(dev)[None, None, :, None].expand(b, vocab, -1, 1)
        g_values = self.sample_g_values(self.accumulate_hash(h[:, :, None], keys))  # [B, V, D]
        updated = self.update_scores(scores, g_values)

        repeated = (self.state["history"] == h_ctx[:, None]).any(dim=1, keepdim=True)
        self.state["history"] = torch.cat([h_ctx[:, None], self.state["history"]],
                                          dim=1)[:, :-1]
        return torch.where(repeated, scores, updated)


class SynthIDTextWatermarkDetector:
    """Mean-g-value detection of SynthID-watermarked text (the reference's
    Bayesian detector, watermarking.py:481, needs a trained scoring model;
    this calibration-free mean detector takes the same inputs: a higher mean g
    over the n-grams means watermarked)."""

    def __init__(self, processor: SynthIDTextWatermarkLogitsProcessor,
                 threshold: float = 0.52):
        self.processor = processor
        self.threshold = threshold

    def __call__(self, input_ids) -> dict:
        """``mean_g_values``, ``z_score`` (against Bernoulli(0.5)) and
        ``prediction`` [B], float64 tensors on the ids' device."""
        g = self.processor.compute_g_values(input_ids)
        mean_g = g.reshape(g.shape[0], -1).double().mean(dim=1)
        n = g.shape[1] * g.shape[2]
        z = (mean_g - 0.5) / (0.5 / math.sqrt(n))
        return {"mean_g_values": mean_g, "z_score": z, "prediction": mean_g > self.threshold}
