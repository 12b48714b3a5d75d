"""Auto classes (port of ``transformers_tpu/models/auto``), for the families
the port has: ``llama`` and the families built on its skeleton, ``mistral``,
``qwen2``, ``qwen3``, ``phi3``, ``gemma``, ``gemma2`` and ``gemma3_text``, and
the mixture-of-experts ``mixtral``, ``qwen2_moe``, ``qwen3_moe``, ``olmoe``,
``phimoe``, ``laguna`` and ``gpt_oss``; the dense bases ``olmo2``,
``ernie4_5``, ``cohere``, ``cohere2`` and ``hunyuan_v1_dense`` and their
mixture-of-experts families ``minimax_m2``, ``ernie4_5_moe``,
``cohere2_moe`` and ``hunyuan_v1_moe``; the DeepSeek tree: ``deepseek_v3``,
``deepseek_v2`` and ``mistral4`` (multi-head latent attention) and the
families on DeepSeek-V3's router, ``glm4_moe``, ``dots1`` and
``solar_open``."""

from __future__ import annotations

import json
import os

from ...configuration_utils import CONFIG_NAME, PretrainedConfig
from ..cohere import CohereConfig, CohereForCausalLM
from ..cohere2 import Cohere2Config, Cohere2ForCausalLM
from ..cohere2_moe import Cohere2MoeConfig, Cohere2MoeForCausalLM
from ..deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM
from ..deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM
from ..dots1 import Dots1Config, Dots1ForCausalLM
from ..ernie4_5 import Ernie4_5Config, Ernie4_5ForCausalLM
from ..ernie4_5_moe import Ernie4_5_MoeConfig, Ernie4_5_MoeForCausalLM
from ..gemma import GemmaConfig, GemmaForCausalLM
from ..gemma2 import Gemma2Config, Gemma2ForCausalLM
from ..gemma3 import Gemma3ForCausalLM, Gemma3TextConfig
from ..glm4_moe import Glm4MoeConfig, Glm4MoeForCausalLM
from ..gpt_oss import GptOssConfig, GptOssForCausalLM
from ..hunyuan_v1_dense import HunYuanDenseV1Config, HunYuanDenseV1ForCausalLM
from ..hunyuan_v1_moe import HunYuanMoEV1Config, HunYuanMoEV1ForCausalLM
from ..laguna import LagunaConfig, LagunaForCausalLM
from ..llama import LlamaConfig, LlamaForCausalLM
from ..minimax_m2 import MiniMaxM2Config, MiniMaxM2ForCausalLM
from ..mistral import MistralConfig, MistralForCausalLM
from ..mistral4 import Mistral4Config, Mistral4ForCausalLM
from ..mixtral import MixtralConfig, MixtralForCausalLM
from ..olmo2 import Olmo2Config, Olmo2ForCausalLM
from ..olmoe import OlmoeConfig, OlmoeForCausalLM
from ..phi3 import Phi3Config, Phi3ForCausalLM
from ..phimoe import PhimoeConfig, PhimoeForCausalLM
from ..qwen2 import Qwen2Config, Qwen2ForCausalLM
from ..qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM
from ..qwen3 import Qwen3Config, Qwen3ForCausalLM
from ..qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM
from ..solar_open import SolarOpenConfig, SolarOpenForCausalLM

CONFIG_MAPPING = {"llama": LlamaConfig, "mistral": MistralConfig, "qwen2": Qwen2Config,
                  "qwen3": Qwen3Config, "phi3": Phi3Config, "gemma": GemmaConfig,
                  "gemma2": Gemma2Config, "gemma3_text": Gemma3TextConfig,
                  "mixtral": MixtralConfig, "qwen2_moe": Qwen2MoeConfig,
                  "qwen3_moe": Qwen3MoeConfig, "olmoe": OlmoeConfig, "phimoe": PhimoeConfig,
                  "laguna": LagunaConfig, "gpt_oss": GptOssConfig, "olmo2": Olmo2Config,
                  "minimax_m2": MiniMaxM2Config, "ernie4_5": Ernie4_5Config,
                  "ernie4_5_moe": Ernie4_5_MoeConfig, "cohere": CohereConfig,
                  "cohere2": Cohere2Config, "cohere2_moe": Cohere2MoeConfig,
                  "hunyuan_v1_dense": HunYuanDenseV1Config,
                  "hunyuan_v1_moe": HunYuanMoEV1Config, "deepseek_v3": DeepseekV3Config,
                  "deepseek_v2": DeepseekV2Config, "mistral4": Mistral4Config,
                  "glm4_moe": Glm4MoeConfig, "dots1": Dots1Config,
                  "solar_open": SolarOpenConfig}
MODEL_FOR_CAUSAL_LM_MAPPING = {
    "llama": LlamaForCausalLM, "mistral": MistralForCausalLM, "qwen2": Qwen2ForCausalLM,
    "qwen3": Qwen3ForCausalLM, "phi3": Phi3ForCausalLM, "gemma": GemmaForCausalLM,
    "gemma2": Gemma2ForCausalLM, "gemma3_text": Gemma3ForCausalLM,
    "mixtral": MixtralForCausalLM, "qwen2_moe": Qwen2MoeForCausalLM,
    "qwen3_moe": Qwen3MoeForCausalLM, "olmoe": OlmoeForCausalLM, "phimoe": PhimoeForCausalLM,
    "laguna": LagunaForCausalLM, "gpt_oss": GptOssForCausalLM, "olmo2": Olmo2ForCausalLM,
    "minimax_m2": MiniMaxM2ForCausalLM, "ernie4_5": Ernie4_5ForCausalLM,
    "ernie4_5_moe": Ernie4_5_MoeForCausalLM, "cohere": CohereForCausalLM,
    "cohere2": Cohere2ForCausalLM, "cohere2_moe": Cohere2MoeForCausalLM,
    "hunyuan_v1_dense": HunYuanDenseV1ForCausalLM, "hunyuan_v1_moe": HunYuanMoEV1ForCausalLM,
    "deepseek_v3": DeepseekV3ForCausalLM, "deepseek_v2": DeepseekV2ForCausalLM,
    "mistral4": Mistral4ForCausalLM, "glm4_moe": Glm4MoeForCausalLM, "dots1": Dots1ForCausalLM,
    "solar_open": SolarOpenForCausalLM}


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
