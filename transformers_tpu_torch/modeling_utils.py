"""PreTrainedModel: config binding, seeded init, from_pretrained / save_pretrained.

Port of ``transformers_tpu/modeling_utils.py`` (reference
src/transformers/modeling_utils.py:1181) onto ``nn.Module``. A model holds its
parameters on one device, given explicitly; entry points default to
``device="cuda"`` and raise when no card is present, rather than carry on on
the CPU (tests pass ``device="cpu"``).
"""

from __future__ import annotations

import logging
import os
from typing import Any, Optional

import torch
from torch import nn

from .configuration_utils import PretrainedConfig
from .core.loading import (checkpoint_state_dict, expert_slots, load_checkpoint_in_model,
                           resolve_checkpoint_files, save_state_dict)

logger = logging.getLogger(__name__)

_STR_TO_DTYPE = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float64": torch.float64,
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
}


def dtype_from_str(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return _STR_TO_DTYPE.get(str(dtype).replace("torch.", ""))


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, "cuda" when not given. Raises when a
    CUDA device is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return device


class PreTrainedModel(nn.Module):
    """Base for all models.

    Subclass contract: ``config_class``; ``base_model_prefix`` (the bare
    transformer's child name); ``__init__(config, *, dtype, param_dtype,
    device)`` builds the children with uninitialised parameters."""

    config_class: type[PretrainedConfig] = PretrainedConfig
    base_model_prefix: str = ""

    def __init__(self, config: PretrainedConfig, *, dtype=torch.float32, param_dtype=None,
                 device="cuda"):
        super().__init__()
        self.config = config
        self.dtype = dtype_from_str(dtype)
        self.param_dtype = dtype_from_str(param_dtype) or self.dtype
        self.device = resolve_device(device)
        self.generation_config = None
        self.load_report = None

    # ------------------------------------------------------------------- init
    def _init_params(self, names, seed: int) -> None:
        """Initialise the named parameters; a checkpoint's per-expert key
        (``expert_slots``) initialises that expert's slice only."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        slots = expert_slots(self)
        for name in names:
            if name in slots:
                stacked, expert = slots[name]
                owner, _, leaf = stacked.rpartition(".")
                self.get_submodule(owner).init_parameter(leaf, gen, expert=expert)
                continue
            owner, _, leaf = name.rpartition(".")
            self.get_submodule(owner).init_parameter(leaf, gen)

    def init_weights(self, seed: int = 0) -> "PreTrainedModel":
        """Fill every parameter from a ``torch.Generator`` seeded with ``seed``:
        normal(0, initializer_range) for Linear and Embedding weights, zeros
        for biases, ones for norm scales."""
        self._init_params([n for n, _ in self.named_parameters()], seed)
        return self

    # --------------------------------------------------------------- training
    def gradient_checkpointing_enable(self, enable: bool = True) -> None:
        """Recompute each decoder layer's forward during the backward pass
        (``torch.utils.checkpoint``, non-reentrant) instead of keeping its
        activations."""
        getattr(self, self.base_model_prefix).gradient_checkpointing = enable

    def gradient_checkpointing_disable(self) -> None:
        self.gradient_checkpointing_enable(False)

    # --------------------------------------------------------------------- IO
    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, *,
                        config: Optional[PretrainedConfig] = None, dtype: Any = "auto",
                        param_dtype: Any = None, device="cuda",
                        attn_implementation: Optional[str] = None, quantization_config=None,
                        seed: int = 0, **config_kwargs) -> "PreTrainedModel":
        """Load config and weights from a local hub-layout directory.

        ``dtype="auto"`` takes the checkpoint's ``config.dtype`` (float32 when
        absent). Weights are streamed one tensor at a time onto ``device``.
        Parameters the checkpoint lacks are initialised from ``seed`` and
        reported in ``model.load_report``. A pre-quantized checkpoint (GPTQ,
        AWQ, compressed-tensors, fp8, bitsandbytes, HQQ, BitNet, named by the
        config's ``quantization_config``) is dequantized on the host as it is
        read (``quantizers/checkpoint_formats.py``). ``quantization_config``
        (``Int8WeightOnlyConfig``, ``Int4WeightOnlyConfig``,
        ``Fp8WeightOnlyConfig``) then quantizes the loaded Linear weights on
        ``device``, one tensor at a time."""
        path = str(pretrained_model_name_or_path)
        if config is None:
            config = cls.config_class.from_pretrained(path, **config_kwargs)
        if attn_implementation is not None:
            config.attn_implementation = attn_implementation
        if dtype == "auto":
            load_dtype = dtype_from_str(getattr(config, "dtype", None)) or torch.float32
        else:
            load_dtype = dtype_from_str(dtype) or torch.float32
        model = cls(config, dtype=load_dtype, param_dtype=param_dtype, device=device)
        checkpoint_files = resolve_checkpoint_files(path)
        config_qdict = getattr(config, "quantization_config", None)
        if isinstance(config_qdict, dict) and config_qdict:
            from .quantizers.checkpoint_formats import (detect_prequantized,
                                                        load_prequantized_checkpoint)

            if detect_prequantized(config_qdict) is not None:
                checkpoint_files = [load_prequantized_checkpoint(checkpoint_files, config_qdict)]
        report = load_checkpoint_in_model(model, checkpoint_files)
        if report.missing_keys:
            model._init_params(report.missing_keys, seed)
        report.log(cls.__name__)
        if quantization_config is not None:
            from .quantizers import quantize_params

            quantize_params(model, quantization_config)
        model.load_report = report

        from .generation.configuration_utils import GENERATION_CONFIG_NAME, GenerationConfig

        gen_path = os.path.join(path, GENERATION_CONFIG_NAME)
        if os.path.isfile(gen_path):
            model.generation_config = GenerationConfig.from_json_file(gen_path)
        else:
            model.generation_config = GenerationConfig.from_model_config(config)
        return model

    def save_pretrained(self, save_directory, **kwargs) -> None:
        """Write ``config.json``, ``generation_config.json`` and the weights as
        safetensors (sharded above ``max_shard_size`` bytes), stacked experts
        one tensor per expert, as the hub and the JAX package write them."""
        self.config.architectures = [type(self).__name__]
        self.config.save_pretrained(save_directory)
        if self.generation_config is not None:
            self.generation_config.save_pretrained(save_directory)
        save_state_dict(checkpoint_state_dict(self), str(save_directory), **kwargs)
