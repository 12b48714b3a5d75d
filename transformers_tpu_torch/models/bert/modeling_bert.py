"""BERT in PyTorch: the bidirectional encoder skeleton of the port.

Port of ``transformers_tpu/models/bert/modeling_bert.py`` (reference
src/transformers/models/bert/modeling_bert.py). Absolute position and
token-type embeddings with LayerNorm; post-LN layers of
``attention.self.{query,key,value}`` + ``attention.output.{dense,LayerNorm}``
and the ``intermediate``/``output`` MLP; a pooler (tanh of ``dense`` over
[CLS]); the MLM, sequence-classification, token-classification and QA heads
under the reference checkpoint names (``cls.predictions.transform...``).
RoBERTa and XLM-RoBERTa subclass this skeleton.

Attention goes through the registry with ``kv_valid`` from the attention
mask and ``is_causal=False``: by default the flash kernel
(ops/flash_attention.py, K1's bidirectional mode) on the card. A full
additive ``attention_bias`` takes the eager path, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...core.module import Embedding, LayerNorm, Linear
from ...loss import (for_masked_lm_loss, for_question_answering_loss,
                     for_sequence_classification_loss, for_token_classification_loss)
from ...modeling_outputs import (BaseModelOutputWithPooling, MaskedLMOutput,
                                 QuestionAnsweringModelOutput, SequenceClassifierOutput,
                                 TokenClassifierOutput)
from ...modeling_utils import PreTrainedModel
from ...ops.activations import get_activation
from ...ops.attention import get_attention_fn
from .configuration_bert import BertConfig


def _kw(config, dtype, param_dtype, device) -> dict:
    return dict(dtype=dtype, param_dtype=param_dtype, device=device,
                init_std=config.initializer_range)


def _norm_kw(dtype, param_dtype, device) -> dict:
    return dict(dtype=dtype, param_dtype=param_dtype, device=device)


def encoder_attn_args(attention_mask, b: int, s: int, device, attention_bias=None) -> dict:
    """The registry's mask arguments of a bidirectional encoder: every query
    sees every slot its row's ``attention_mask`` keeps; a full additive
    ``attention_bias`` [B, 1, S, S] replaces the mask."""
    if attention_bias is not None:
        return {"bias": attention_bias, "is_causal": False}
    kv_valid = (attention_mask.to(torch.int32) if attention_mask is not None
                else torch.ones((b, s), dtype=torch.int32, device=device))
    return {"kv_valid": kv_valid, "is_causal": False}


class BertEmbeddings(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        kw = _kw(config, dtype, param_dtype, device)
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings, config.hidden_size,
                                             **kw)
        self.token_type_embeddings = Embedding(config.type_vocab_size, config.hidden_size, **kw)
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   **_norm_kw(dtype, param_dtype, device))

    def position_ids(self, input_ids, s: int, device):
        return torch.arange(s, device=device)[None, :]

    def forward(self, input_ids, token_type_ids=None, position_ids=None, inputs_embeds=None):
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings(input_ids)
        s = inputs_embeds.shape[1]
        if position_ids is None:
            position_ids = self.position_ids(input_ids, s, inputs_embeds.device)
        if token_type_ids is None:
            token_type_ids = torch.zeros(inputs_embeds.shape[:2], dtype=torch.long,
                                         device=inputs_embeds.device)
        h = (inputs_embeds + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        return self.LayerNorm(h)


class BertSelfAttention(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        kw = _kw(config, dtype, param_dtype, device)
        self.query = Linear(config.hidden_size, config.hidden_size, True, **kw)
        self.key = Linear(config.hidden_size, config.hidden_size, True, **kw)
        self.value = Linear(config.hidden_size, config.hidden_size, True, **kw)

    def forward(self, hidden, attn_args):
        b, s, e = hidden.shape
        q = self.query(hidden).reshape(b, s, self.num_heads, self.head_dim)
        k = self.key(hidden).reshape(b, s, self.num_heads, self.head_dim)
        v = self.value(hidden).reshape(b, s, self.num_heads, self.head_dim)
        attn_fn = get_attention_fn(self.config.attn_implementation)
        out = attn_fn(q, k, v, scale=self.head_dim ** -0.5, **attn_args)
        return out.reshape(b, s, e)


class BertSelfOutput(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size, True,
                            **_kw(config, dtype, param_dtype, device))
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   **_norm_kw(dtype, param_dtype, device))

    def forward(self, hidden, residual):
        return self.LayerNorm(self.dense(hidden) + residual)


class BertAttention(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.self = BertSelfAttention(config, **kw)
        self.output = BertSelfOutput(config, **kw)

    def forward(self, hidden, attn_args):
        return self.output(self.self(hidden, attn_args), hidden)


class BertIntermediate(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.intermediate_size, True,
                            **_kw(config, dtype, param_dtype, device))
        self.act = get_activation(config.hidden_act)

    def forward(self, x):
        return self.act(self.dense(x))


class BertOutput(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dense = Linear(config.intermediate_size, config.hidden_size, True,
                            **_kw(config, dtype, param_dtype, device))
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   **_norm_kw(dtype, param_dtype, device))

    def forward(self, hidden, residual):
        return self.LayerNorm(self.dense(hidden) + residual)


class BertLayer(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.attention = BertAttention(config, **kw)
        self.intermediate = BertIntermediate(config, **kw)
        self.output = BertOutput(config, **kw)

    def forward(self, hidden, attn_args):
        hidden = self.attention(hidden, attn_args)
        return self.output(self.intermediate(hidden), hidden)


class BertEncoder(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(config, **kw)
                                    for _ in range(config.num_hidden_layers)])

    def forward(self, hidden, attn_args, output_hidden_states=False):
        all_hidden = [] if output_hidden_states else None
        for layer in self.layer:
            if output_hidden_states:
                all_hidden.append(hidden)
            hidden = layer(hidden, attn_args)
        if output_hidden_states:
            all_hidden.append(hidden)
        return hidden, all_hidden


class BertPooler(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size, True,
                            **_kw(config, dtype, param_dtype, device))

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Bare encoder (reference modeling_bert.py BertModel)."""

    embeddings_cls = BertEmbeddings

    def __init__(self, config: BertConfig, *, dtype, param_dtype, device,
                 add_pooling_layer: bool = True):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.embeddings = self.embeddings_cls(config, **kw)
        self.encoder = BertEncoder(config, **kw)
        self.pooler = BertPooler(config, **kw) if add_pooling_layer else None

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, output_hidden_states: bool = False,
                output_attentions: bool = False,
                attention_bias: Optional[torch.Tensor] = None) -> BaseModelOutputWithPooling:
        hidden = self.embeddings(input_ids, token_type_ids, position_ids, inputs_embeds)
        b, s, _ = hidden.shape
        attn_args = encoder_attn_args(attention_mask, b, s, hidden.device, attention_bias)
        probs_sink = [] if output_attentions else None
        if output_attentions:
            attn_args["probs_sink"] = probs_sink
        hidden, all_hidden = self.encoder(hidden, attn_args, output_hidden_states)
        pooled = self.pooler(hidden) if self.pooler is not None else None
        return BaseModelOutputWithPooling(
            last_hidden_state=hidden, pooler_output=pooled,
            hidden_states=tuple(all_hidden) if all_hidden is not None else None,
            attentions=tuple(probs_sink) if probs_sink is not None else None)


class BertPredictionHeadTransform(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size, True,
                            **_kw(config, dtype, param_dtype, device))
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps,
                                   **_norm_kw(dtype, param_dtype, device))
        self.act = get_activation(config.hidden_act)

    def forward(self, x):
        return self.LayerNorm(self.act(self.dense(x)))


class BertLMPredictionHead(nn.Module):
    """``cls.predictions``: transform, then the word-embedding table as the
    decoder (tied: never a parameter of its own), plus ``bias``."""

    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dtype = dtype
        self.transform = BertPredictionHeadTransform(config, dtype=dtype,
                                                     param_dtype=param_dtype, device=device)
        self.bias = nn.Parameter(torch.empty((config.vocab_size,), dtype=param_dtype,
                                             device=device))

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        self.bias.zero_()

    def forward(self, hidden, embeddings: Embedding):
        return embeddings.attend(self.transform(hidden)) + self.bias.to(self.dtype)


class BertOnlyMLMHead(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.predictions = BertLMPredictionHead(config, **kw)

    def forward(self, hidden, embeddings: Embedding):
        return self.predictions(hidden, embeddings)


class BertPreTrainedModel(PreTrainedModel):
    config_class = BertConfig
    base_model_prefix = "bert"
    model_cls = BertModel

    def _encoder(self, pooling: bool = True) -> BertModel:
        return self.model_cls(self.config, dtype=self.dtype, param_dtype=self.param_dtype,
                         device=self.device, add_pooling_layer=pooling)

    def _linear(self, out_features: int) -> Linear:
        return Linear(self.config.hidden_size, out_features, True, dtype=self.dtype,
                      param_dtype=self.param_dtype, device=self.device,
                      init_std=self.config.initializer_range)

    @property
    def base(self) -> nn.Module:
        return getattr(self, self.base_model_prefix)


class BertModelStandalone(BertPreTrainedModel):
    """The bare encoder as a loadable checkpoint target (``AutoModel``)."""

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.bert = self._encoder()

    def forward(self, *args, **kwargs) -> BaseModelOutputWithPooling:
        return self.bert(*args, **kwargs)


class BertForMaskedLM(BertPreTrainedModel):
    """Reference modeling_bert.py BertForMaskedLM (``cls.predictions``). The
    checkpoint's ``cls.predictions.decoder.*`` are tied duplicates of the word
    embeddings and ``predictions.bias``: the head reads the table itself."""

    _keys_to_ignore_on_load_unexpected = (r"cls\.predictions\.decoder\.", r"\.position_ids$")

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.bert = self._encoder(pooling=False)
        self.cls = BertOnlyMLMHead(config, dtype=self.dtype, param_dtype=self.param_dtype,
                                   device=self.device)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, labels=None,
                output_hidden_states: bool = False, **kwargs) -> MaskedLMOutput:
        outputs = self.bert(input_ids, attention_mask, token_type_ids, position_ids,
                            inputs_embeds, output_hidden_states)
        logits = self.cls(outputs.last_hidden_state, self.bert.embeddings.word_embeddings)
        loss = (for_masked_lm_loss(logits, labels, self.config.vocab_size)
                if labels is not None else None)
        return MaskedLMOutput(loss=loss, logits=logits, hidden_states=outputs.hidden_states)


class BertForSequenceClassification(BertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        self.bert = self._encoder()
        self.classifier = self._linear(config.num_labels)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, labels=None,
                **kwargs) -> SequenceClassifierOutput:
        outputs = self.bert(input_ids, attention_mask, token_type_ids, position_ids,
                            inputs_embeds)
        logits = self.classifier(outputs.pooler_output)
        loss = (for_sequence_classification_loss(logits, labels, self.config)
                if labels is not None else None)
        return SequenceClassifierOutput(loss=loss, logits=logits,
                                        hidden_states=outputs.hidden_states)


class BertForTokenClassification(BertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        setattr(self, self.base_model_prefix, self._encoder(pooling=False))
        self.classifier = self._linear(config.num_labels)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, labels=None,
                **kwargs) -> TokenClassifierOutput:
        outputs = self.base(input_ids, attention_mask, token_type_ids, position_ids,
                            inputs_embeds)
        logits = self.classifier(outputs.last_hidden_state)
        loss = (for_token_classification_loss(logits, labels, self.config)
                if labels is not None else None)
        return TokenClassifierOutput(loss=loss, logits=logits,
                                     hidden_states=outputs.hidden_states)


class BertForQuestionAnswering(BertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        setattr(self, self.base_model_prefix, self._encoder(pooling=False))
        self.qa_outputs = self._linear(2)

    def forward(self, input_ids=None, attention_mask=None, token_type_ids=None,
                position_ids=None, inputs_embeds=None, start_positions=None,
                end_positions=None, **kwargs) -> QuestionAnsweringModelOutput:
        outputs = self.base(input_ids, attention_mask, token_type_ids, position_ids,
                            inputs_embeds)
        logits = self.qa_outputs(outputs.last_hidden_state)
        start_logits, end_logits = logits[..., 0], logits[..., 1]
        loss = None
        if start_positions is not None and end_positions is not None:
            loss = for_question_answering_loss(start_logits, end_logits, start_positions,
                                               end_positions)
        return QuestionAnsweringModelOutput(loss=loss, start_logits=start_logits,
                                            end_logits=end_logits,
                                            hidden_states=outputs.hidden_states)
