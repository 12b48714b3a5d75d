"""Streamed checkpoint loading into a module's ``state_dict``, and saving.

Port of ``transformers_tpu/core/loading.py``. Hub tensor names map one to one
onto the port's parameter names, and Linear weights keep torch's
``[out, in]`` layout, so loading is a key intersection: each tensor is read
from the safetensors mapping, checked for shape, and copied into its
parameter (cast to the parameter's dtype, moved to its device) before the
next one is read. Keys present on one side only are reported.

The one exception is a mixture-of-experts block's experts where the
checkpoint holds one tensor per expert and projection and the port one
stacked parameter per projection (``ops/moe.py`` ``Experts``).
``expert_slots`` maps each per-expert key to its slice, which the tensor is
copied into as it streams (the stacked parameter is never assembled a second
time), and ``checkpoint_state_dict`` writes the slices back under the
per-expert keys. A checkpoint that stacks the experts itself (gpt-oss's
``mlp.experts.gate_up_proj``, a module with ``per_expert_checkpoint`` False)
loads and saves each stacked tensor whole, as any other key.
"""

from __future__ import annotations

import json
import logging
import os
import re
from dataclasses import dataclass, field

import torch
from torch import nn

from .safetensors import SafetensorsFile, save_file

logger = logging.getLogger(__name__)

SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"


@dataclass
class LoadReport:
    """Missing, unexpected and shape-mismatched keys of one load."""

    missing_keys: list[str] = field(default_factory=list)
    unexpected_keys: list[str] = field(default_factory=list)
    mismatched_keys: list[tuple[str, tuple, tuple]] = field(default_factory=list)

    def drop_ignored(self, patterns) -> None:
        """Take out of ``unexpected_keys`` the keys any of ``patterns`` (regular
        expressions) finds: a class's ``_keys_to_ignore_on_load_unexpected``,
        such as a tied decoder the checkpoint duplicates."""
        self.unexpected_keys = [k for k in self.unexpected_keys
                                if not any(re.search(p, k) for p in patterns)]

    def log(self, name: str):
        if self.unexpected_keys:
            logger.warning(f"Some weights of the checkpoint were not used when initializing "
                           f"{name}: {self.unexpected_keys[:16]}")
        if self.missing_keys:
            logger.warning(f"Some weights of {name} were newly initialized (missing from the "
                           f"checkpoint): {self.missing_keys[:16]}")
        if self.mismatched_keys:
            logger.warning(f"Shape-mismatched keys skipped: {self.mismatched_keys}")


def resolve_checkpoint_files(directory: str) -> list[str]:
    """The safetensors file of a local checkpoint directory, or its shards as
    named by ``model.safetensors.index.json``."""
    single = os.path.join(directory, SAFE_WEIGHTS_NAME)
    if os.path.isfile(single):
        return [single]
    index = os.path.join(directory, SAFE_WEIGHTS_INDEX_NAME)
    if os.path.isfile(index):
        with open(index, encoding="utf-8") as f:
            weight_map = json.load(f)["weight_map"]
        return [os.path.join(directory, name) for name in sorted(set(weight_map.values()))]
    raise OSError(f"No model weights found in {directory!r} (looked for "
                  f"{SAFE_WEIGHTS_NAME} and {SAFE_WEIGHTS_INDEX_NAME})")


class DictSource:
    """An in-memory state dict (torch tensors or numpy arrays) as a checkpoint
    source: the dequantized output of a pre-quantized checkpoint, test
    fixtures."""

    def __init__(self, tensors: dict):
        self._tensors = tensors

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass

    def keys(self) -> list[str]:
        return list(self._tensors)

    def get_shape(self, key: str) -> tuple[int, ...]:
        return tuple(self._tensors[key].shape)

    def get_tensor(self, key: str) -> torch.Tensor:
        return torch.as_tensor(self._tensors[key])


def open_checkpoint_source(file):
    """A checkpoint entry's reader (JAX ``core/loading.py`` ``open_checkpoint_source``):
    a path -> safetensors (the only format ``resolve_checkpoint_files`` gives);
    a dict -> in memory."""
    if isinstance(file, (str, os.PathLike)):
        return SafetensorsFile(str(file))
    if isinstance(file, dict):
        return DictSource(file)
    raise TypeError(f"a checkpoint entry is a file path or a state dict, got {type(file)}")


def expert_slots(model: nn.Module) -> dict[str, tuple[str, int]]:
    """The checkpoint key of each expert's projection, ``<experts>.<e>.<name>.weight``,
    -> (the stacked parameter's name, e), for every module that keeps its
    experts stacked (its ``stacked_names``) where the checkpoint holds them
    per expert."""
    slots = {}
    for prefix, module in model.named_modules():
        if not getattr(module, "per_expert_checkpoint", True):
            continue
        for name in getattr(module, "stacked_names", ()):
            for e in range(getattr(module, name).shape[0]):
                slots[f"{prefix}.{e}.{name}.weight"] = (f"{prefix}.{name}", e)
    return slots


def checkpoint_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """``model.state_dict()`` under the checkpoint's names: each stacked
    expert parameter as one tensor per expert (views, no copy)."""
    per_param: dict[str, list] = {}
    for key, (name, e) in expert_slots(model).items():
        per_param.setdefault(name, []).append((key, e))
    out = {}
    for name, t in model.state_dict().items():
        for key, e in per_param.get(name, [(name, None)]):
            out[key] = t if e is None else t[e]
    return out


@torch.no_grad()
def load_checkpoint_in_model(model: nn.Module, checkpoint_files: list) -> LoadReport:
    """Stream every tensor of the checkpoint entries (file paths or in-memory
    state dicts, ``open_checkpoint_source``) into ``model``'s parameters. A
    checkpoint of the bare base model loads into a task model and the other
    way round, by adding or stripping ``model.base_model_prefix``. A stacked
    expert parameter takes its experts' tensors (``expert_slots``); a missing
    expert is reported by its per-expert key."""
    params = dict(model.named_parameters())
    slots = expert_slots(model)
    prefix = getattr(model, "base_model_prefix", "")
    report = LoadReport()
    seen: set[str] = set()

    def known(key: str) -> bool:
        return key in params or key in slots

    def fix_prefix(key: str) -> str:
        if known(key) or not prefix:
            return key
        pref = prefix + "."
        if key.startswith(pref) and known(key[len(pref):]):
            return key[len(pref):]
        if known(pref + key):
            return pref + key
        return key

    for entry in checkpoint_files:
        with open_checkpoint_source(entry) as f:
            for ckpt_key in f.keys():
                key = fix_prefix(ckpt_key)
                if key in slots:
                    name, e = slots[key]
                    param = params[name][e]
                else:
                    param = params.get(key)
                if param is None:
                    report.unexpected_keys.append(ckpt_key)
                    continue
                shape = f.get_shape(ckpt_key)
                if shape != tuple(param.shape):
                    report.mismatched_keys.append((key, shape, tuple(param.shape)))
                    continue
                param.copy_(f.get_tensor(ckpt_key))
                seen.add(key)
    stacked = {name for name, _ in slots.values()}
    report.missing_keys = sorted(
        [k for k in params if k not in seen and k not in stacked]
        + [k for k, (name, _) in slots.items() if k not in seen and name not in seen])
    return report


def save_state_dict(state_dict: dict[str, torch.Tensor], save_directory: str, *,
                    max_shard_size: int = 5 * 1024**3) -> None:
    """Write a state dict hub-compatibly: one ``model.safetensors`` or, above
    ``max_shard_size`` bytes, numbered shards plus the index file."""
    os.makedirs(save_directory, exist_ok=True)
    total = sum(t.numel() * t.element_size() for t in state_dict.values())
    if total <= max_shard_size:
        save_file(state_dict, os.path.join(save_directory, SAFE_WEIGHTS_NAME),
                  metadata={"format": "pt"})
        return
    shards: list[dict[str, torch.Tensor]] = [{}]
    size = 0
    for key, t in state_dict.items():
        nbytes = t.numel() * t.element_size()
        if size + nbytes > max_shard_size and shards[-1]:
            shards.append({})
            size = 0
        shards[-1][key] = t
        size += nbytes
    weight_map = {}
    for i, shard in enumerate(shards):
        name = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        save_file(shard, os.path.join(save_directory, name), metadata={"format": "pt"})
        weight_map.update({k: name for k in shard})
    index = {"metadata": {"total_size": total}, "weight_map": weight_map}
    with open(os.path.join(save_directory, SAFE_WEIGHTS_INDEX_NAME), "w", encoding="utf-8") as f:
        json.dump(index, f, indent=2, sort_keys=True)
