"""Causal-LM loss (port of ``transformers_tpu/loss/__init__.py``: reference
src/transformers/loss/loss_utils.py:49).

Computed in float32 whatever the logits' dtype, with the reference's ignore
index (-100). The mean is over ``max(count, 1)`` non-ignored labels, written
out as a sum and a count: a batch whose every label is ignored gives 0, where
``F.cross_entropy`` would give NaN.
"""

from __future__ import annotations

from typing import Optional

import torch

IGNORE_INDEX = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  ignore_index: int = IGNORE_INDEX, label_smoothing: float = 0.0) -> torch.Tensor:
    """Mean token-level CE over non-ignored labels. logits [N, V], labels [N].
    With ``label_smoothing`` eps each token's loss is (1 - eps) * nll + eps *
    mean(-logprobs) (JAX ``Trainer._smoothed_loss``)."""
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -logprobs.gather(-1, safe_labels[:, None])[:, 0]
    if label_smoothing:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logprobs.mean(dim=-1)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)


def for_causal_lm_loss(logits: torch.Tensor, labels: Optional[torch.Tensor], vocab_size: int,
                       *, ignore_index: int = IGNORE_INDEX,
                       shift_labels: Optional[torch.Tensor] = None,
                       label_smoothing: float = 0.0) -> torch.Tensor:
    """Shift-by-one CE (reference loss_utils.py:49 ``ForCausalLMLoss``), or CE
    against ``shift_labels`` that are already shifted."""
    if shift_labels is None:
        logits = logits[:, :-1, :]
        shift_labels = labels[:, 1:]
    return cross_entropy(logits.reshape(-1, vocab_size), shift_labels.reshape(-1),
                         ignore_index=ignore_index, label_smoothing=label_smoothing)
