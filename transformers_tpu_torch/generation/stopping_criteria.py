"""Stopping criteria (port of ``transformers_tpu/generation/stopping_criteria.py``;
reference src/transformers/generation/stopping_criteria.py).

Two kinds, by where they run:
- the device criteria, max length and EOS, are part of ``generate()``'s
  decode step (its loop bound and its ``finished`` flags), with no class;
- the host criteria here see every token on ``generate()``'s streaming route
  (``stopping_criteria=``, ``stop_strings=``), which reads each step back.

Each criterion takes the host ids so far, ``input_ids`` [B, L] (numpy), and
returns bool [B]: True where the row should stop.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


class StoppingCriteria:
    def __call__(self, input_ids: np.ndarray, scores=None) -> np.ndarray:
        """bool [B]: True where the row should stop."""
        raise NotImplementedError


class MaxLengthCriteria(StoppingCriteria):
    def __init__(self, max_length: int):
        self.max_length = max_length

    def __call__(self, input_ids, scores=None):
        return np.full((input_ids.shape[0],), input_ids.shape[1] >= self.max_length)


class MaxTimeCriteria(StoppingCriteria):
    """Stop every row once ``max_time`` seconds have passed since
    ``initial_timestamp`` (by default, the criterion's creation)."""

    def __init__(self, max_time: float, initial_timestamp: Optional[float] = None):
        self.max_time = max_time
        self.initial_timestamp = time.time() if initial_timestamp is None else initial_timestamp

    def __call__(self, input_ids, scores=None):
        done = time.time() - self.initial_timestamp > self.max_time
        return np.full((input_ids.shape[0],), done)


class EosTokenCriteria(StoppingCriteria):
    """Stop the rows whose last token is one of ``eos_token_id``."""

    def __init__(self, eos_token_id):
        self.eos_token_id = (tuple(eos_token_id) if isinstance(eos_token_id, (list, tuple))
                             else (eos_token_id,))

    def __call__(self, input_ids, scores=None):
        return np.isin(np.asarray(input_ids)[:, -1], self.eos_token_id)


class StopStringCriteria(StoppingCriteria):
    """Stop a row when the text of its last tokens holds a stop string near its
    end. ``tokenizer`` is any object with ``decode(ids, **kw) -> str``; only a
    tail of ``max_len + 8`` tokens is decoded (the reference's tensorized
    matcher is a host decode here, as in the JAX package)."""

    def __init__(self, tokenizer, stop_strings):
        self.tokenizer = tokenizer
        self.stop_strings = [stop_strings] if isinstance(stop_strings, str) else list(stop_strings)
        self.max_len = max(len(s) for s in self.stop_strings)

    def __call__(self, input_ids, scores=None):
        tail = np.asarray(input_ids)[:, -(self.max_len + 8):]
        out = np.zeros((tail.shape[0],), bool)
        for i, row in enumerate(tail):
            text = self.tokenizer.decode([int(t) for t in row], skip_special_tokens=False)
            out[i] = any(text.endswith(s) or s in text[-2 * self.max_len:]
                         for s in self.stop_strings)
        return out


class StoppingCriteriaList(list):
    def __call__(self, input_ids, scores=None):
        done = np.zeros((input_ids.shape[0],), bool)
        for c in self:
            done |= np.asarray(c(input_ids, scores), bool)
        return done
