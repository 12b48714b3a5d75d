"""RoBERTa in PyTorch (port of ``transformers_tpu/models/roberta/modeling_roberta.py``;
reference src/transformers/models/roberta/modeling_roberta.py).

BERT's skeleton with pad-offset position ids, taken from ``input_ids`` and
not from the mask: real tokens count from ``padding_idx + 1`` and pad slots
get ``padding_idx`` (``create_position_ids_from_input_ids`` in the
reference); its own head names (``lm_head.{dense,layer_norm,bias}`` over the
tied word-embedding table, ``classifier.{dense,out_proj}`` over ``<s>``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.module import Embedding, LayerNorm, Linear
from ...loss import for_masked_lm_loss, for_sequence_classification_loss
from ...modeling_outputs import (BaseModelOutputWithPooling, MaskedLMOutput,
                                 SequenceClassifierOutput)
from ...ops.activations import get_activation
from ..bert.modeling_bert import (BertEmbeddings, BertForQuestionAnswering,
                                  BertForTokenClassification, BertModel, BertPreTrainedModel)
from .configuration_roberta import RobertaConfig


def position_ids_from_input_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    """Real tokens at ``padding_idx + 1, + 2, ...`` in their order; pad
    tokens at ``padding_idx``."""
    mask = (input_ids != padding_idx).to(torch.int32)
    return torch.cumsum(mask, dim=1, dtype=torch.int32) * mask + padding_idx


class RobertaEmbeddings(BertEmbeddings):
    def __init__(self, config, **kw):
        super().__init__(config, **kw)
        self.padding_idx = config.pad_token_id

    def position_ids(self, input_ids, s: int, device):
        if input_ids is None:
            return super().position_ids(input_ids, s, device)
        return position_ids_from_input_ids(input_ids, self.padding_idx)


class RobertaModel(BertModel):
    embeddings_cls = RobertaEmbeddings


class RobertaPreTrainedModel(BertPreTrainedModel):
    config_class = RobertaConfig
    base_model_prefix = "roberta"
    model_cls = RobertaModel


class RobertaModelStandalone(RobertaPreTrainedModel):
    """The bare encoder as a loadable checkpoint target (``AutoModel``)."""

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.roberta = self._encoder()

    def forward(self, *args, **kwargs) -> BaseModelOutputWithPooling:
        return self.roberta(*args, **kwargs)


class RobertaLMHead(nn.Module):
    """``lm_head``: dense, gelu, ``layer_norm``, then the tied decoder (the
    word-embedding table) plus ``bias``."""

    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.dense = Linear(config.hidden_size, config.hidden_size, True, dtype=dtype,
                            param_dtype=param_dtype, device=device,
                            init_std=config.initializer_range)
        self.layer_norm = LayerNorm(config.hidden_size, config.layer_norm_eps, dtype=dtype,
                                    param_dtype=param_dtype, device=device)
        self.bias = nn.Parameter(torch.empty((config.vocab_size,), dtype=param_dtype,
                                             device=device))
        self.act = get_activation("gelu")

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.bias.zero_()

    def forward(self, hidden, embeddings: Embedding):
        h = self.layer_norm(self.act(self.dense(hidden)))
        return embeddings.attend(h) + self.bias.to(self.dtype)


class RobertaForMaskedLM(RobertaPreTrainedModel):
    _keys_to_ignore_on_load_unexpected = (r"lm_head\.decoder\.", r"\.position_ids$")

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.roberta = self._encoder(pooling=False)
        self.lm_head = RobertaLMHead(config, dtype=self.dtype, param_dtype=self.param_dtype,
                                     device=self.device)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, labels=None,
                output_hidden_states: bool = False, **kwargs) -> MaskedLMOutput:
        outputs = self.roberta(input_ids, attention_mask, token_type_ids, position_ids,
                               inputs_embeds, output_hidden_states)
        logits = self.lm_head(outputs.last_hidden_state, self.roberta.embeddings.word_embeddings)
        loss = (for_masked_lm_loss(logits, labels, self.config.vocab_size)
                if labels is not None else None)
        return MaskedLMOutput(loss=loss, logits=logits, hidden_states=outputs.hidden_states)


class RobertaClassificationHead(nn.Module):
    """``classifier``: dense over the ``<s>`` token, tanh, ``out_proj``."""

    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.dense = Linear(config.hidden_size, config.hidden_size, True, **kw)
        self.out_proj = Linear(config.hidden_size, config.num_labels, True, **kw)

    def forward(self, hidden):
        return self.out_proj(torch.tanh(self.dense(hidden[:, 0])))


class RobertaForSequenceClassification(RobertaPreTrainedModel):
    _keys_to_ignore_on_load_unexpected = (r"\.position_ids$",)

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        self.roberta = self._encoder(pooling=False)
        self.classifier = RobertaClassificationHead(config, dtype=self.dtype,
                                                    param_dtype=self.param_dtype,
                                                    device=self.device)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, labels=None,
                **kwargs) -> SequenceClassifierOutput:
        outputs = self.roberta(input_ids, attention_mask, token_type_ids, position_ids,
                               inputs_embeds)
        logits = self.classifier(outputs.last_hidden_state)
        loss = (for_sequence_classification_loss(logits, labels, self.config)
                if labels is not None else None)
        return SequenceClassifierOutput(loss=loss, logits=logits,
                                        hidden_states=outputs.hidden_states)


class RobertaForTokenClassification(BertForTokenClassification):
    config_class = RobertaConfig
    base_model_prefix = "roberta"
    model_cls = RobertaModel
    _keys_to_ignore_on_load_unexpected = (r"\.position_ids$",)


class RobertaForQuestionAnswering(BertForQuestionAnswering):
    config_class = RobertaConfig
    base_model_prefix = "roberta"
    model_cls = RobertaModel
    _keys_to_ignore_on_load_unexpected = (r"\.position_ids$",)
