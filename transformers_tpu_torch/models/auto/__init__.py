"""Auto classes (port of ``transformers_tpu/models/auto``), for the families
the port has: ``llama``."""

from __future__ import annotations

import json
import os

from ...configuration_utils import CONFIG_NAME, PretrainedConfig
from ..llama import LlamaConfig, LlamaForCausalLM

CONFIG_MAPPING = {"llama": LlamaConfig}
MODEL_FOR_CAUSAL_LM_MAPPING = {"llama": LlamaForCausalLM}


def _lookup(mapping: dict, model_type):
    if model_type not in mapping:
        raise ValueError(f"model_type {model_type!r} is not ported yet; "
                         f"the port has {sorted(mapping)}")
    return mapping[model_type]


class AutoConfig:
    def __init__(self):
        raise EnvironmentError("use AutoConfig.from_pretrained(...)")

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs) -> PretrainedConfig:
        path = os.path.join(str(pretrained_model_name_or_path), CONFIG_NAME)
        with open(path, encoding="utf-8") as f:
            model_type = json.load(f).get("model_type")
        return _lookup(CONFIG_MAPPING, model_type).from_pretrained(
            pretrained_model_name_or_path, **kwargs)

    @classmethod
    def for_model_type(cls, model_type, **kwargs) -> PretrainedConfig:
        return _lookup(CONFIG_MAPPING, model_type)(**kwargs)


class AutoModelForCausalLM:
    def __init__(self):
        raise EnvironmentError("use AutoModelForCausalLM.from_pretrained(...) or .from_config(...)")

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs):
        config = kwargs.pop("config", None) or AutoConfig.from_pretrained(
            pretrained_model_name_or_path)
        model_cls = _lookup(MODEL_FOR_CAUSAL_LM_MAPPING, config.model_type)
        return model_cls.from_pretrained(pretrained_model_name_or_path, config=config, **kwargs)

    @classmethod
    def from_config(cls, config: PretrainedConfig, **kwargs):
        return _lookup(MODEL_FOR_CAUSAL_LM_MAPPING, config.model_type)(config, **kwargs)
