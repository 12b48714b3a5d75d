"""Mistral decoder (port of transformers_tpu/models/mistral/modeling_mistral.py;
reference src/transformers/models/mistral/modeling_mistral.py).

The Llama skeleton with a sliding window on every layer: the window comes from
the config (``layer_sliding_window``), so the model is a config swap. The
window reaches every kernel of the path: K1 masks the prefill with it, K2's
first live slot moves up to ``pos + 1 - window``, and K6 reads only the
window's slots of each row's pages.
"""

from __future__ import annotations

from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaForQuestionAnswering,
    LlamaForSequenceClassification,
    LlamaForTokenClassification,
    LlamaMLP,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_mistral import MistralConfig


# nothing to add to the skeleton: the names the JAX package exports
MistralMLP = LlamaMLP
MistralAttention = LlamaAttention
MistralDecoderLayer = LlamaDecoderLayer
MistralModel = LlamaModel


class MistralForCausalLM(LlamaForCausalLM):
    config_class = MistralConfig
    model_cls = MistralModel


class MistralModelStandalone(LlamaModelStandalone):
    config_class = MistralConfig
    model_cls = MistralModel


class MistralForSequenceClassification(LlamaForSequenceClassification):
    config_class = MistralConfig
    model_cls = MistralModel


class MistralForTokenClassification(LlamaForTokenClassification):
    config_class = MistralConfig
    model_cls = MistralModel


class MistralForQuestionAnswering(LlamaForQuestionAnswering):
    config_class = MistralConfig
    model_cls = MistralModel
