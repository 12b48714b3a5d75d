"""XLM-RoBERTa in PyTorch (port of
``transformers_tpu/models/xlm_roberta/modeling_xlm_roberta.py``; reference
models/xlm_roberta/modeling_xlm_roberta.py): RoBERTa's architecture under the
``xlm-roberta`` model_type. The auto classes send its sequence-
classification, token-classification and QA heads to RoBERTa's classes."""

from __future__ import annotations

from ..roberta.configuration_roberta import RobertaConfig
from ..roberta.modeling_roberta import RobertaForMaskedLM, RobertaModel, RobertaModelStandalone


class XLMRobertaConfig(RobertaConfig):
    model_type = "xlm-roberta"


class XLMRobertaModel(RobertaModel):
    pass


class XLMRobertaModelStandalone(RobertaModelStandalone):
    config_class = XLMRobertaConfig
    model_cls = XLMRobertaModel


class XLMRobertaForMaskedLM(RobertaForMaskedLM):
    config_class = XLMRobertaConfig
    model_cls = XLMRobertaModel
