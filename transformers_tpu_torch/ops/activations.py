"""Activation registry (port of ``transformers_tpu/ops/activations.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gelu_new(x):
    """GPT-2's tanh-approximated gelu (reference activations.py NewGELUActivation)."""
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


def gelu_pytorch_tanh(x):
    return F.gelu(x, approximate="tanh")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def gelu_exact(x):
    return F.gelu(x)


ACT2FN = {
    "gelu": gelu_exact,
    "gelu_new": gelu_new,
    "gelu_fast": gelu_new,
    "gelu_pytorch_tanh": gelu_pytorch_tanh,
    "gelu_python": gelu_exact,
    "quick_gelu": quick_gelu,
    "relu": F.relu,
    "relu2": lambda x: torch.square(F.relu(x)),
    "relu6": F.relu6,
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "mish": F.mish,
    "leaky_relu": F.leaky_relu,
    "linear": lambda x: x,
    "hard_swish": F.hardswish,
    "hardswish": F.hardswish,
}


def get_activation(name: str):
    if name not in ACT2FN:
        raise KeyError(f"Unknown activation {name!r}; known: {sorted(ACT2FN)}")
    return ACT2FN[name]
