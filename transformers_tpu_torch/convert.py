"""Weights of the JAX package as the port's ``state_dict``.

``params_from_jax`` takes the nested params of a ``transformers_tpu`` model,
already turned into numpy (``jax.tree.map(np.asarray, params)``), and returns
the port's weights under the same dotted hub names. The JAX ``Linear`` keeps
its kernel as ``[in, out]``; the port keeps torch's ``[out, in]``, so every
2-D ``weight`` is transposed except an ``embed_tokens`` table, which both keep
as ``[vocab, hidden]``. Norm scales and biases pass as they are. A model with
tied word embeddings has no ``lm_head`` on either side. bf16 and fp8 e4m3
arrays (the ``ml_dtypes`` types) are read by their bits, so the port needs no
``ml_dtypes``.

Weight-only quantized leaves (``transformers_tpu.quantizers``) follow the same
rule, which gives the port's layouts: int8 codes ``[in, out]`` -> ``[out, in]``;
packed int4 ``[in / 2, out]`` -> ``[out, in / 2]`` (byte ``j`` of row ``n``
then holds codes ``(n, 2j)`` and ``(n, 2j + 1)``, low nibble first, as
``quantizers/weight_only.py`` packs them); fp8 codes ``[in, out]`` ->
``[out, in]`` as ``torch.float8_e4m3fn``; ``weight_scale`` [out] as it is.
A model takes them with ``load_state_dict`` once ``quantize_params`` has made
its Linears quantized.

A mixture-of-experts block keeps each expert as its own subtree
(``experts: {"0": {"w1": {"weight": [in, out]}}, ...}``); the port keeps one
stacked parameter per projection, ``experts.w1`` ``[E, out, in]``
(``ops/moe.py`` ``Experts``), so those subtrees are stacked, each expert's
kernel transposed.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: arrays taken from JAX are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(arr)


def _flatten(tree: dict, prefix: str = ""):
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            yield from _flatten(value, key + ".")
        else:
            yield key, value


def _stack_experts(tree: dict) -> dict:
    """``tree`` with every ``experts`` subtree keyed by expert number replaced
    by {projection: its experts' kernels transposed and stacked, [E, out, in]}."""
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            if name == "experts" and value and all(k.isdigit() for k in value):
                experts = [value[str(e)] for e in range(len(value))]
                value = {proj: np.stack([np.asarray(x[proj]["weight"]).T for x in experts])
                         for proj in experts[0]}
            else:
                value = _stack_experts(value)
        out[name] = value
    return out


def params_from_jax(jax_params_numpy: dict) -> dict[str, torch.Tensor]:
    state_dict = {}
    for key, value in _flatten(_stack_experts(jax_params_numpy)):
        t = _to_torch(np.asarray(value))
        if key.endswith(".weight") and t.ndim == 2 and not key.endswith("embed_tokens.weight"):
            t = t.T.contiguous()
        state_dict[key] = t
    return state_dict
