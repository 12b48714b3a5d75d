"""Weights of the JAX package as the port's ``state_dict``.

``params_from_jax`` takes the nested params of a ``transformers_tpu`` model,
already turned into numpy (``jax.tree.map(np.asarray, params)``), and returns
the port's weights under the same dotted hub names. The JAX ``Linear`` keeps
its kernel as ``[in, out]``; the port keeps torch's ``[out, in]``, so every
2-D ``weight`` is transposed except an ``embed_tokens`` table, which both keep
as ``[vocab, hidden]``. Norm scales and biases pass as they are. A model with
tied word embeddings has no ``lm_head`` on either side. bf16 arrays (the
``ml_dtypes`` type) are read by their bits, so the port needs no
``ml_dtypes``.
"""

from __future__ import annotations

import numpy as np
import torch


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: arrays taken from JAX are read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _flatten(tree: dict, prefix: str = ""):
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if isinstance(value, dict):
            yield from _flatten(value, key + ".")
        else:
            yield key, value


def params_from_jax(jax_params_numpy: dict) -> dict[str, torch.Tensor]:
    state_dict = {}
    for key, value in _flatten(jax_params_numpy):
        t = _to_torch(np.asarray(value))
        if key.endswith(".weight") and t.ndim == 2 and not key.endswith("embed_tokens.weight"):
            t = t.T.contiguous()
        state_dict[key] = t
    return state_dict
