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
``solar_open``; the encoders ``bert``, ``roberta``, ``xlm-roberta``,
``distilbert`` and ``modernbert``.

The task classes take exactly the JAX package's mapping rows
(``transformers_tpu/models/auto/modeling_auto.py``) for these families:
``AutoModel`` maps every family to its bare model (a decoder's
``*ModelStandalone``, defined in the family's module), the sequence-,
token-classification and QA classes map the encoders and Llama, Mistral and
Qwen2 (XLM-RoBERTa to RoBERTa's heads), ``AutoModelForMaskedLM`` the
encoders. A ``model_type`` a class does not map raises, naming it."""

from __future__ import annotations

import json
import os

from ...configuration_utils import CONFIG_NAME, PretrainedConfig
from ..bert import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                    BertForSequenceClassification, BertForTokenClassification,
                    BertModelStandalone)
from ..cohere import CohereConfig, CohereForCausalLM, CohereModelStandalone
from ..cohere2 import Cohere2Config, Cohere2ForCausalLM, Cohere2ModelStandalone
from ..cohere2_moe import Cohere2MoeConfig, Cohere2MoeForCausalLM, Cohere2MoeModelStandalone
from ..deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM, DeepseekV2ModelStandalone
from ..deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM, DeepseekV3ModelStandalone
from ..distilbert import (DistilBertConfig, DistilBertForMaskedLM,
                          DistilBertForQuestionAnswering, DistilBertForSequenceClassification,
                          DistilBertModelStandalone)
from ..dots1 import Dots1Config, Dots1ForCausalLM, Dots1ModelStandalone
from ..ernie4_5 import Ernie4_5Config, Ernie4_5ForCausalLM, Ernie4_5ModelStandalone
from ..ernie4_5_moe import Ernie4_5_MoeConfig, Ernie4_5_MoeForCausalLM, Ernie4_5_MoeModelStandalone
from ..gemma import GemmaConfig, GemmaForCausalLM, GemmaModelStandalone
from ..gemma2 import Gemma2Config, Gemma2ForCausalLM, Gemma2ModelStandalone
from ..gemma3 import Gemma3ForCausalLM, Gemma3TextConfig, Gemma3TextModelStandalone
from ..glm4_moe import Glm4MoeConfig, Glm4MoeForCausalLM, Glm4MoeModelStandalone
from ..gpt_oss import GptOssConfig, GptOssForCausalLM, GptOssModelStandalone
from ..hunyuan_v1_dense import (HunYuanDenseV1Config, HunYuanDenseV1ForCausalLM,
                                HunYuanDenseV1ModelStandalone)
from ..hunyuan_v1_moe import (HunYuanMoEV1Config, HunYuanMoEV1ForCausalLM,
                              HunYuanMoEV1ModelStandalone)
from ..laguna import LagunaConfig, LagunaForCausalLM, LagunaModelStandalone
from ..llama import (LlamaConfig, LlamaForCausalLM, LlamaForQuestionAnswering,
                     LlamaForSequenceClassification, LlamaForTokenClassification,
                     LlamaModelStandalone)
from ..minimax_m2 import MiniMaxM2Config, MiniMaxM2ForCausalLM, MiniMaxM2ModelStandalone
from ..mistral import (MistralConfig, MistralForCausalLM, MistralForQuestionAnswering,
                       MistralForSequenceClassification, MistralForTokenClassification,
                       MistralModelStandalone)
from ..mistral4 import Mistral4Config, Mistral4ForCausalLM, Mistral4ModelStandalone
from ..mixtral import MixtralConfig, MixtralForCausalLM, MixtralModelStandalone
from ..modernbert import (ModernBertConfig, ModernBertForMaskedLM,
                          ModernBertForSequenceClassification, ModernBertForTokenClassification,
                          ModernBertModelStandalone)
from ..olmo2 import Olmo2Config, Olmo2ForCausalLM, Olmo2ModelStandalone
from ..olmoe import OlmoeConfig, OlmoeForCausalLM, OlmoeModelStandalone
from ..phi3 import Phi3Config, Phi3ForCausalLM, Phi3ModelStandalone
from ..phimoe import PhimoeConfig, PhimoeForCausalLM, PhimoeModelStandalone
from ..qwen2 import (Qwen2Config, Qwen2ForCausalLM, Qwen2ForQuestionAnswering,
                     Qwen2ForSequenceClassification, Qwen2ForTokenClassification,
                     Qwen2ModelStandalone)
from ..qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM, Qwen2MoeModelStandalone
from ..qwen3 import Qwen3Config, Qwen3ForCausalLM, Qwen3ModelStandalone
from ..qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM, Qwen3MoeModelStandalone
from ..roberta import (RobertaConfig, RobertaForMaskedLM, RobertaForQuestionAnswering,
                       RobertaForSequenceClassification, RobertaForTokenClassification,
                       RobertaModelStandalone)
from ..solar_open import SolarOpenConfig, SolarOpenForCausalLM, SolarOpenModelStandalone
from ..xlm_roberta import XLMRobertaConfig, XLMRobertaForMaskedLM, XLMRobertaModelStandalone

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
                  "solar_open": SolarOpenConfig, "bert": BertConfig, "roberta": RobertaConfig,
                  "xlm-roberta": XLMRobertaConfig, "distilbert": DistilBertConfig,
                  "modernbert": ModernBertConfig}
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


MODEL_MAPPING = {
    "llama": LlamaModelStandalone, "mistral": MistralModelStandalone, "qwen2": Qwen2ModelStandalone,
    "qwen3": Qwen3ModelStandalone, "phi3": Phi3ModelStandalone, "gemma": GemmaModelStandalone,
    "gemma2": Gemma2ModelStandalone, "gemma3_text": Gemma3TextModelStandalone,
    "mixtral": MixtralModelStandalone, "qwen2_moe": Qwen2MoeModelStandalone,
    "qwen3_moe": Qwen3MoeModelStandalone, "olmoe": OlmoeModelStandalone,
    "phimoe": PhimoeModelStandalone, "laguna": LagunaModelStandalone,
    "gpt_oss": GptOssModelStandalone, "olmo2": Olmo2ModelStandalone,
    "minimax_m2": MiniMaxM2ModelStandalone, "ernie4_5": Ernie4_5ModelStandalone,
    "ernie4_5_moe": Ernie4_5_MoeModelStandalone, "cohere": CohereModelStandalone,
    "cohere2": Cohere2ModelStandalone, "cohere2_moe": Cohere2MoeModelStandalone,
    "hunyuan_v1_dense": HunYuanDenseV1ModelStandalone,
    "hunyuan_v1_moe": HunYuanMoEV1ModelStandalone, "deepseek_v3": DeepseekV3ModelStandalone,
    "deepseek_v2": DeepseekV2ModelStandalone, "mistral4": Mistral4ModelStandalone,
    "glm4_moe": Glm4MoeModelStandalone, "dots1": Dots1ModelStandalone,
    "solar_open": SolarOpenModelStandalone, "bert": BertModelStandalone,
    "roberta": RobertaModelStandalone, "xlm-roberta": XLMRobertaModelStandalone,
    "distilbert": DistilBertModelStandalone, "modernbert": ModernBertModelStandalone}
MODEL_FOR_SEQUENCE_CLASSIFICATION_MAPPING = {
    "llama": LlamaForSequenceClassification, "mistral": MistralForSequenceClassification,
    "qwen2": Qwen2ForSequenceClassification, "bert": BertForSequenceClassification,
    "roberta": RobertaForSequenceClassification,
    "xlm-roberta": RobertaForSequenceClassification,
    "distilbert": DistilBertForSequenceClassification,
    "modernbert": ModernBertForSequenceClassification}
MODEL_FOR_TOKEN_CLASSIFICATION_MAPPING = {
    "llama": LlamaForTokenClassification, "mistral": MistralForTokenClassification,
    "qwen2": Qwen2ForTokenClassification, "bert": BertForTokenClassification,
    "modernbert": ModernBertForTokenClassification, "roberta": RobertaForTokenClassification,
    "xlm-roberta": RobertaForTokenClassification}
MODEL_FOR_QUESTION_ANSWERING_MAPPING = {
    "llama": LlamaForQuestionAnswering, "mistral": MistralForQuestionAnswering,
    "qwen2": Qwen2ForQuestionAnswering, "bert": BertForQuestionAnswering,
    "roberta": RobertaForQuestionAnswering, "xlm-roberta": RobertaForQuestionAnswering,
    "distilbert": DistilBertForQuestionAnswering}
MODEL_FOR_MASKED_LM_MAPPING = {
    "bert": BertForMaskedLM, "roberta": RobertaForMaskedLM,
    "xlm-roberta": XLMRobertaForMaskedLM, "distilbert": DistilBertForMaskedLM,
    "modernbert": ModernBertForMaskedLM}


def _lookup(mapping: dict, model_type):
    if model_type not in mapping:
        raise ValueError(f"model_type {model_type!r} is not ported yet for this class; "
                         f"the port maps {sorted(mapping)}")
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


class _BaseAutoModelClass:
    """``from_pretrained`` / ``from_config`` through ``_model_mapping``."""

    _model_mapping: dict = {}

    def __init__(self):
        raise EnvironmentError(f"use {type(self).__name__}.from_pretrained(...) or "
                               f".from_config(...)")

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path, **kwargs):
        config = kwargs.pop("config", None) or AutoConfig.from_pretrained(
            pretrained_model_name_or_path)
        model_cls = _lookup(cls._model_mapping, config.model_type)
        return model_cls.from_pretrained(pretrained_model_name_or_path, config=config, **kwargs)

    @classmethod
    def from_config(cls, config: PretrainedConfig, **kwargs):
        return _lookup(cls._model_mapping, config.model_type)(config, **kwargs)


class AutoModelForCausalLM(_BaseAutoModelClass):
    _model_mapping = MODEL_FOR_CAUSAL_LM_MAPPING


class AutoModel(_BaseAutoModelClass):
    _model_mapping = MODEL_MAPPING


class AutoModelForSequenceClassification(_BaseAutoModelClass):
    _model_mapping = MODEL_FOR_SEQUENCE_CLASSIFICATION_MAPPING


class AutoModelForTokenClassification(_BaseAutoModelClass):
    _model_mapping = MODEL_FOR_TOKEN_CLASSIFICATION_MAPPING


class AutoModelForQuestionAnswering(_BaseAutoModelClass):
    _model_mapping = MODEL_FOR_QUESTION_ANSWERING_MAPPING


class AutoModelForMaskedLM(_BaseAutoModelClass):
    _model_mapping = MODEL_FOR_MASKED_LM_MAPPING
