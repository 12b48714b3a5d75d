"""Quantizer framework.

Port of ``transformers_tpu/quantizers/base.py`` (reference
src/transformers/quantizers/base.py:73 ``HfQuantizer`` and
utils/quantization_config.py). A quantizer turns the weights of a loaded
model's ``Linear`` modules into codes plus a ``weight_scale`` [out] float32
tensor (``Linear.set_quantized``), under the same dotted names the JAX
package's ``flatten_dict`` gives its params; the Linear forward then computes
from the codes (``ops/quantized_linear.py``).
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass

import torch

logger = logging.getLogger(__name__)

_QUANTIZER_REGISTRY: dict[str, type] = {}


def register_quantizer(method: str):
    def deco(cls):
        _QUANTIZER_REGISTRY[method] = cls
        return cls

    return deco


@dataclass
class QuantizationConfig:
    """Base config (reference utils/quantization_config.py)."""

    quant_method: str = ""
    # param-path regexes never quantized (lm_head, embeddings, norms by default)
    modules_to_not_convert: tuple = (r"embed", r"lm_head", r"norm", r"\.bias$", r"logit")


class Quantizer:
    """Lifecycle hooks (reference quantizers/base.py:73)."""

    def __init__(self, config: QuantizationConfig):
        self.config = config

    def should_quantize(self, key: str, value: torch.Tensor) -> bool:
        if value.ndim != 2 or not key.endswith("weight"):
            return False
        return not any(re.search(p, key) for p in self.config.modules_to_not_convert)

    def quantize_tensor(self, key: str, value: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(codes, scale [out] float32) of a torch-layout [out, in] weight."""
        raise NotImplementedError


def get_quantizer(config: QuantizationConfig) -> Quantizer:
    if config.quant_method not in _QUANTIZER_REGISTRY:
        raise KeyError(f"Unknown quant_method {config.quant_method!r}; "
                       f"known: {sorted(_QUANTIZER_REGISTRY)}")
    return _QUANTIZER_REGISTRY[config.quant_method](config)


@torch.no_grad()
def quantize_params(model, config: QuantizationConfig):
    """Quantize every eligible ``Linear`` weight of ``model`` in place, one tensor
    at a time on the weight's device (the load-time analog of reference
    ``preprocess_model`` + ``param_needs_quantization``). Weights already
    quantized are skipped. Returns ``model``."""
    from ..core.module import Linear

    quantizer = get_quantizer(config)
    n = 0
    for name, module in model.named_modules():
        if not isinstance(module, Linear) or module.weight_scale is not None:
            continue  # already quantized (re-quantizing codes = garbage)
        key = f"{name}.weight"
        if not quantizer.should_quantize(key, module.weight):
            continue
        codes, scale = quantizer.quantize_tensor(key, module.weight)
        module.set_quantized(codes, scale)
        n += 1
    logger.info(f"Quantized {n} weights with {config.quant_method}")
    return model
