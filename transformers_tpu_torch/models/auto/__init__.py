"""Auto classes (port of ``transformers_tpu/models/auto``), for the families
the port has: ``llama`` and the families built on its skeleton, ``mistral``,
``qwen2``, ``qwen3``, ``phi3``, ``gemma``, ``gemma2`` and ``gemma3_text``, and
the mixture-of-experts ``mixtral``, ``qwen2_moe`` and ``qwen3_moe``."""

from __future__ import annotations

import json
import os

from ...configuration_utils import CONFIG_NAME, PretrainedConfig
from ..gemma import GemmaConfig, GemmaForCausalLM
from ..gemma2 import Gemma2Config, Gemma2ForCausalLM
from ..gemma3 import Gemma3ForCausalLM, Gemma3TextConfig
from ..llama import LlamaConfig, LlamaForCausalLM
from ..mistral import MistralConfig, MistralForCausalLM
from ..mixtral import MixtralConfig, MixtralForCausalLM
from ..phi3 import Phi3Config, Phi3ForCausalLM
from ..qwen2 import Qwen2Config, Qwen2ForCausalLM
from ..qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM
from ..qwen3 import Qwen3Config, Qwen3ForCausalLM
from ..qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM

CONFIG_MAPPING = {"llama": LlamaConfig, "mistral": MistralConfig, "qwen2": Qwen2Config,
                  "qwen3": Qwen3Config, "phi3": Phi3Config, "gemma": GemmaConfig,
                  "gemma2": Gemma2Config, "gemma3_text": Gemma3TextConfig,
                  "mixtral": MixtralConfig, "qwen2_moe": Qwen2MoeConfig,
                  "qwen3_moe": Qwen3MoeConfig}
MODEL_FOR_CAUSAL_LM_MAPPING = {
    "llama": LlamaForCausalLM, "mistral": MistralForCausalLM, "qwen2": Qwen2ForCausalLM,
    "qwen3": Qwen3ForCausalLM, "phi3": Phi3ForCausalLM, "gemma": GemmaForCausalLM,
    "gemma2": Gemma2ForCausalLM, "gemma3_text": Gemma3ForCausalLM,
    "mixtral": MixtralForCausalLM, "qwen2_moe": Qwen2MoeForCausalLM,
    "qwen3_moe": Qwen3MoeForCausalLM}


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
