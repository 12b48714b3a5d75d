"""Logits processors that ``generate()`` builds by default.

Port of the temperature, top-k and top-p warpers of
``transformers_tpu/generation/logits_process.py``. Each is a function of
``(logits, state)``, where ``state`` carries the decode buffers
(``ids`` [B, T], ``mask`` [B, T], ``pos``, ``gen_count``), and runs on the
logits' device.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # large but finite, so a softmax over filtered rows stays NaN-free


class LogitsProcessorList(list):
    def __call__(self, logits: torch.Tensor, state: dict) -> torch.Tensor:
        for proc in self:
            logits = proc(logits, state)
        return logits


class TemperatureLogitsWarper:
    """reference logits_process.py TemperatureLogitsWarper"""

    def __init__(self, temperature: float):
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.temperature = float(temperature)

    def __call__(self, logits, state):
        return logits / self.temperature


class TopKLogitsWarper:
    """Keep the top-k logits (reference TopKLogitsWarper)."""

    def __init__(self, top_k: int, filter_value: float = NEG_INF):
        self.top_k = int(top_k)
        self.filter_value = filter_value

    def __call__(self, logits, state):
        k = min(self.top_k, logits.shape[-1])
        if k <= 0:
            return logits
        threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
        return logits.masked_fill(logits < threshold, self.filter_value)


class TopPLogitsWarper:
    """Nucleus sampling (reference TopPLogitsWarper): keep the tokens whose
    cumulative probability, counted before each one, is below top_p."""

    def __init__(self, top_p: float, filter_value: float = NEG_INF, min_tokens_to_keep: int = 1):
        self.top_p = float(top_p)
        self.filter_value = filter_value
        self.min_tokens_to_keep = min_tokens_to_keep

    def __call__(self, logits, state):
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (probs.cumsum(dim=-1) - probs) < self.top_p
        keep[..., :self.min_tokens_to_keep] = True
        threshold = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        return logits.masked_fill(logits < threshold, self.filter_value)
