"""Generic task heads on a decoder backbone (port of
``transformers_tpu/modeling_layers.py``; reference
src/transformers/modeling_layers.py ``GenericForSequenceClassification``
:118, ``GenericForQuestionAnswering`` :193, ``GenericForTokenClassification``
:254). A family adds a task model by subclassing and setting
``config_class`` and ``model_cls``; the backbone keeps its checkpoint prefix
(``model`` for the classification heads, ``transformer`` for QA).
"""

from __future__ import annotations

from typing import Optional

import torch

from .core.module import Linear
from .loss import (for_question_answering_loss, for_sequence_classification_loss,
                   for_token_classification_loss)
from .modeling_outputs import (BaseModelOutputWithPast, QuestionAnsweringModelOutput,
                               SequenceClassifierOutputWithPast, TokenClassifierOutput)
from .modeling_utils import PreTrainedModel


def last_token_indices(input_ids: Optional[torch.Tensor], attention_mask: Optional[torch.Tensor],
                       pad_token_id: Optional[int], seq_len: Optional[int] = None
                       ) -> torch.Tensor:
    """Each row's sequence-summary position (reference modeling_layers.py:146):
    the last token that is not ``pad_token_id``. ``attention_mask`` is not
    consulted when there is a pad id, as in the reference; without one, the
    mask's last kept slot, else the last slot."""
    if input_ids is None or pad_token_id is None:
        if attention_mask is not None:
            return (attention_mask.to(torch.int64).sum(-1) - 1).clamp_min(0)
        b, s = (input_ids.shape if input_ids is not None else (1, seq_len))
        return torch.full((b,), s - 1, dtype=torch.int64)
    non_pad = (input_ids != pad_token_id).to(torch.int64)
    idx = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
    return (idx * non_pad).argmax(-1)


class _DecoderHead(PreTrainedModel):
    model_cls = None

    def _backbone(self):
        return self.model_cls(self.config, dtype=self.dtype, param_dtype=self.param_dtype,
                              device=self.device)

    def _head(self, out_features: int, use_bias: bool) -> Linear:
        return Linear(self.config.hidden_size, out_features, use_bias, dtype=self.dtype,
                      param_dtype=self.param_dtype, device=self.device, init_std=0.02)

    def _hidden(self, input_ids, attention_mask, position_ids, past_key_values, cache_position,
                inputs_embeds) -> BaseModelOutputWithPast:
        backbone = getattr(self, self.base_model_prefix)
        return backbone(input_ids, attention_mask, position_ids, past_key_values,
                        cache_position, inputs_embeds)


class GenericForSequenceClassification(_DecoderHead):
    """Backbone + ``score`` (no bias), pooled at each row's last non-pad token."""

    base_model_prefix = "model"

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        self.model = self._backbone()
        self.score = self._head(self.num_labels, False)

    def forward(self, input_ids=None, attention_mask=None, position_ids=None,
                past_key_values=None, cache_position=0, inputs_embeds=None, labels=None,
                **kwargs) -> SequenceClassifierOutputWithPast:
        outputs = self._hidden(input_ids, attention_mask, position_ids, past_key_values,
                               cache_position, inputs_embeds)
        logits = self.score(outputs.last_hidden_state)  # [B, S, L]
        idx = last_token_indices(input_ids, attention_mask, self.config.pad_token_id,
                                 logits.shape[1]).to(logits.device)
        pooled = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        loss = (for_sequence_classification_loss(pooled, labels, self.config)
                if labels is not None else None)
        return SequenceClassifierOutputWithPast(loss=loss, logits=pooled,
                                                past_key_values=outputs.past_key_values,
                                                hidden_states=outputs.hidden_states)


class GenericForTokenClassification(_DecoderHead):
    base_model_prefix = "model"

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        self.model = self._backbone()
        self.score = self._head(self.num_labels, True)

    def forward(self, input_ids=None, attention_mask=None, position_ids=None,
                past_key_values=None, cache_position=0, inputs_embeds=None, labels=None,
                **kwargs) -> TokenClassifierOutput:
        outputs = self._hidden(input_ids, attention_mask, position_ids, past_key_values,
                               cache_position, inputs_embeds)
        logits = self.score(outputs.last_hidden_state)
        loss = (for_token_classification_loss(logits, labels, self.config)
                if labels is not None else None)
        return TokenClassifierOutput(loss=loss, logits=logits, hidden_states=outputs.hidden_states)


class GenericForQuestionAnswering(_DecoderHead):
    base_model_prefix = "transformer"

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.transformer = self._backbone()
        self.qa_outputs = self._head(2, True)

    def forward(self, input_ids=None, attention_mask=None, position_ids=None,
                past_key_values=None, cache_position=0, inputs_embeds=None,
                start_positions=None, end_positions=None,
                **kwargs) -> QuestionAnsweringModelOutput:
        outputs = self._hidden(input_ids, attention_mask, position_ids, past_key_values,
                               cache_position, inputs_embeds)
        logits = self.qa_outputs(outputs.last_hidden_state)
        start_logits, end_logits = logits[..., 0], logits[..., 1]
        loss = None
        if start_positions is not None and end_positions is not None:
            loss = for_question_answering_loss(start_logits, end_logits, start_positions,
                                               end_positions)
        return QuestionAnsweringModelOutput(loss=loss, start_logits=start_logits,
                                            end_logits=end_logits,
                                            hidden_states=outputs.hidden_states)


class ModelStandalone(_DecoderHead):
    """A decoder family's bare transformer as a loadable checkpoint target
    (``AutoModel``, feature extraction): its ``model_cls`` under ``model``."""

    base_model_prefix = "model"

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.model = self._backbone()

    def forward(self, *args, **kwargs) -> BaseModelOutputWithPast:
        return self.model(*args, **kwargs)

