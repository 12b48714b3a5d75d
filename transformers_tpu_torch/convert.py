"""Weights of the JAX package as the port's ``state_dict``.

``params_from_jax`` takes the nested params of a ``transformers_tpu`` model,
already turned into numpy (``jax.tree.map(np.asarray, params)``), and returns
the port's weights under the same dotted hub names. The JAX ``Linear`` keeps
its kernel as ``[in, out]``; the port keeps torch's ``[out, in]``, so every
2-D ``weight`` is transposed except an embedding table (a decoder's
``embed_tokens``, an encoder's ``word_embeddings``, ``position_embeddings``,
``token_type_embeddings`` or ModernBERT's ``tok_embeddings``), which both
keep as ``[rows, hidden]``. The encoders' and task heads' trees (BERT's
``cls.predictions``, RoBERTa's ``lm_head``, DistilBERT's ``vocab_projector``
and ModernBERT's ``decoder`` biases, the classifiers, ``score`` and
``qa_outputs``) follow the same rule. Norm scales and biases pass as they
are. A model with tied word embeddings has no ``lm_head`` on either side.
bf16 and fp8 e4m3 arrays (the ``ml_dtypes`` types) are read by their bits, so
the port needs no ``ml_dtypes``.

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
kernel transposed. gpt-oss's experts are raw stacked ``[E, in, out]``
parameters on both sides (``experts.gate_up_proj``, its ``_bias``), so they
pass as they are; its router ``weight`` is a 2-D kernel like any other.
Cohere2-MoE's experts are raw stacked parameters in the hub's MixtralExperts
layout (``experts.gate_up_proj`` ``[E, 2I, H]``, ``experts.down_proj``
``[E, H, I]``, no biases): ``gate_up_proj`` is split at I into the port's
``gate_proj`` and ``up_proj``. OLMoE's full-width q/k norms,
``self_attn.full_q_norm`` / ``full_k_norm`` in the JAX package, are the port's
``self_attn.q_norm`` / ``k_norm``, the checkpoint's names.

Some 2-D ``weight``s are no kernels and keep their layout: a norm's (Cohere's
head-wise q/k LayerNorm, ``[heads, D]``), ERNIE-4.5 MoE's router
``mlp.gate.weight``, which the JAX package keeps as the hub's float32
``[E, H]`` (the block beside it holds ``moe_statics``), and DeepSeek-V2's
router, which it keeps as the hub's float32 ``[E, H]`` too: its tree does
not say so, so the caller names the family (``model_type="deepseek_v2"``).
The routers of DeepSeek-V3 and the families on its MoE block (Mistral4,
GLM-4.5, dots.llm1, Solar-Open) are JAX ``[H, E]`` kernels, transposed as
any other; their ``e_score_correction_bias`` passes as it is.
"""

from __future__ import annotations

from typing import Optional

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
            elif name == "experts" and set(value) == {"gate_up_proj", "down_proj"}:
                gate_up = np.asarray(value["gate_up_proj"])
                inner = gate_up.shape[1] // 2
                value = {"gate_proj": gate_up[:, :inner], "up_proj": gate_up[:, inner:],
                         "down_proj": value["down_proj"]}
            else:
                value = _stack_experts(value)
        out[name] = value
    return out


# JAX names the port does not keep: (the JAX name's part, the port's)
_RENAMES = ((".self_attn.full_q_norm.", ".self_attn.q_norm."),
            (".self_attn.full_k_norm.", ".self_attn.k_norm."))


# families whose JAX model keeps every MoE router (``<block>.gate.weight``) as
# the hub's [E, H]
_ROUTERS_IN_HUB_LAYOUT = ("deepseek_v2",)


def _is_kernel(key: str, keys, model_type: Optional[str]) -> bool:
    """Whether a 2-D ``weight`` is a JAX ``[in, out]`` kernel to transpose."""
    module = key[:-len(".weight")]
    if module.endswith(("embed_tokens", "embeddings", "norm")):
        return False
    block, _, leaf = module.rpartition(".")
    if leaf == "gate" and model_type in _ROUTERS_IN_HUB_LAYOUT:
        return False
    # ERNIE-4.5 MoE's router, kept in the hub's layout beside moe_statics
    statics = (block + "." if block else "") + "moe_statics.e_score_correction_bias"
    return not (leaf == "gate" and statics in keys)


def params_from_jax(jax_params_numpy: dict, model_type: Optional[str] = None
                    ) -> dict[str, torch.Tensor]:
    """The port's state dict of a JAX params tree; ``model_type`` names the
    family where its tree alone does not give a weight's layout."""
    flat = dict(_flatten(_stack_experts(jax_params_numpy)))
    state_dict = {}
    for key, value in flat.items():
        t = _to_torch(np.asarray(value))
        if key.endswith(".weight") and t.ndim == 2 and _is_kernel(key, flat, model_type):
            t = t.T.contiguous()
        for jax_part, port_part in _RENAMES:
            key = key.replace(jax_part, port_part)
        state_dict[key] = t
    return state_dict
