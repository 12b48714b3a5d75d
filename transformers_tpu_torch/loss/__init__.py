"""Losses of the causal LM and the task heads (port of
``transformers_tpu/loss/__init__.py``: reference
src/transformers/loss/loss_utils.py:49-149).

Computed in float32 whatever the logits' dtype, with the reference's ignore
index (-100). The mean is over ``max(count, 1)`` non-ignored labels, written
out as a sum and a count: a batch whose every label is ignored gives 0, where
``F.cross_entropy`` would give NaN.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def for_masked_lm_loss(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int,
                       *, ignore_index: int = IGNORE_INDEX) -> torch.Tensor:
    return cross_entropy(logits.reshape(-1, vocab_size), labels.reshape(-1),
                         ignore_index=ignore_index)


def for_sequence_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                                     config) -> torch.Tensor:
    """By ``config.problem_type``, or when it is unset: regression (MSE) for
    one label, single-label cross-entropy for integer labels, else
    multi-label sigmoid BCE."""
    num_labels = config.num_labels
    problem_type = getattr(config, "problem_type", None)
    if problem_type is None:
        if num_labels == 1:
            problem_type = "regression"
        elif labels.dtype in (torch.int32, torch.int64):
            problem_type = "single_label_classification"
        else:
            problem_type = "multi_label_classification"
    logits32 = logits.float()
    if problem_type == "regression":
        return torch.mean(torch.square(logits32.squeeze() - labels.float().squeeze()))
    if problem_type == "single_label_classification":
        return cross_entropy(logits32.reshape(-1, num_labels), labels.reshape(-1))
    labels32 = labels.float()
    return -torch.mean(labels32 * F.logsigmoid(logits32)
                       + (1.0 - labels32) * F.logsigmoid(-logits32))


def for_token_classification_loss(logits: torch.Tensor, labels: torch.Tensor,
                                  config) -> torch.Tensor:
    return cross_entropy(logits.reshape(-1, config.num_labels), labels.reshape(-1))


def for_question_answering_loss(start_logits, end_logits, start_positions,
                                end_positions) -> torch.Tensor:
    """Mean of the start and end cross-entropies; positions are clamped to
    ``seq_len``, which is also the ignore index."""
    seq_len = start_logits.shape[1]
    start_positions = start_positions.clamp(0, seq_len)
    end_positions = end_positions.clamp(0, seq_len)
    start_loss = cross_entropy(start_logits, start_positions, ignore_index=seq_len)
    end_loss = cross_entropy(end_logits, end_positions, ignore_index=seq_len)
    return (start_loss + end_loss) / 2.0
