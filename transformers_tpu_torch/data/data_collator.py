"""Data collators of the port (``transformers_tpu/data/data_collator.py``;
reference src/transformers/data/data_collator.py).

Host code: numpy as in the JAX package, with the batch handed back as torch
tensors on the CPU; the Trainer moves them to its device. None of them adds
``position_ids``: a batch that carries them takes the model's
packed-sequence mask, which the flash kernels do not take.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch


def _to_torch(batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def default_data_collator(features: list[dict]) -> dict:
    """Stack same-key features; ``label``/``label_ids`` become ``labels`` and
    strings are dropped."""
    if not features:
        return {}
    batch = {}
    for key, value in features[0].items():
        if isinstance(value, str):
            continue
        out_key = "labels" if key in ("label", "label_ids") else key
        batch[out_key] = np.stack([np.asarray(f[key]) for f in features])
    return _to_torch(batch)


@dataclass
class DataCollatorWithPadding:
    """Pad to the longest (or a multiple) with the tokenizer's ``pad``."""

    tokenizer: Any
    padding: Any = True
    max_length: Optional[int] = None
    pad_to_multiple_of: Optional[int] = None

    def __call__(self, features: list[dict]) -> dict:
        batch = dict(self.tokenizer.pad(
            features, padding=self.padding, max_length=self.max_length,
            pad_to_multiple_of=self.pad_to_multiple_of, return_tensors="np"))
        for key in ("label", "label_ids"):
            if key in batch:
                batch["labels"] = batch.pop(key)
        return _to_torch(batch)


@dataclass
class DataCollatorForLanguageModeling:
    """Causal-LM labels: a copy of the inputs with pad tokens set to -100.
    Masked-LM (``mlm=True``) is not ported."""

    tokenizer: Any
    mlm: bool = False
    mlm_probability: float = 0.15
    pad_to_multiple_of: Optional[int] = None
    seed: Optional[int] = None

    def __post_init__(self):
        if self.mlm:
            raise ValueError("masked-LM collation is not ported; use mlm=False")

    def __call__(self, features: list) -> dict:
        if isinstance(features[0], dict):
            batch = self.tokenizer.pad(features, padding=True,
                                       pad_to_multiple_of=self.pad_to_multiple_of,
                                       return_tensors="np")
            input_ids = np.asarray(batch["input_ids"])
            attention_mask = batch.get("attention_mask")
        else:
            input_ids = np.stack([np.asarray(f) for f in features])
            attention_mask = np.ones_like(input_ids)
        labels = input_ids.copy()
        if self.tokenizer.pad_token_id is not None:
            labels[labels == self.tokenizer.pad_token_id] = -100
        out = {"input_ids": input_ids, "labels": labels}
        if attention_mask is not None:
            out["attention_mask"] = np.asarray(attention_mask)
        return _to_torch(out)
