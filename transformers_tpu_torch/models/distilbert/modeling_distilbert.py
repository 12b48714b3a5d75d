"""DistilBERT in PyTorch (port of
``transformers_tpu/models/distilbert/modeling_distilbert.py``; reference
src/transformers/models/distilbert/modeling_distilbert.py).

Embeddings without token types (:82); post-LN blocks
``sa_layer_norm(attn + x)`` then ``output_layer_norm(ffn + h)`` (:227-257);
``q_lin``/``k_lin``/``v_lin``/``out_lin`` (:150); the MLM head
``vocab_transform`` -> act -> ``vocab_layer_norm`` -> the tied
``vocab_projector`` (the word-embedding table, with a bias of its own;
:510-513); the sequence head [CLS] -> ``pre_classifier`` -> ReLU ->
``classifier`` (:593-597); the QA head. No token-classification head, as in
the JAX package. Checkpoint layout: ``distilbert.{embeddings,transformer.layer.N}``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...core.module import Bias, Embedding, LayerNorm, Linear
from ...loss import (for_masked_lm_loss, for_question_answering_loss,
                     for_sequence_classification_loss)
from ...modeling_outputs import (BaseModelOutputWithPooling, MaskedLMOutput,
                                 QuestionAnsweringModelOutput, SequenceClassifierOutput)
from ...modeling_utils import PreTrainedModel
from ...ops.activations import get_activation
from ...ops.attention import get_attention_fn
from ..bert.modeling_bert import encoder_attn_args
from .configuration_distilbert import DistilBertConfig

LN_EPS = 1e-12


class DistilBertEmbeddings(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.word_embeddings = Embedding(config.vocab_size, config.dim, **kw)
        self.position_embeddings = Embedding(config.max_position_embeddings, config.dim, **kw)
        self.LayerNorm = LayerNorm(config.dim, LN_EPS, dtype=dtype, param_dtype=param_dtype,
                                   device=device)

    def forward(self, input_ids, position_ids=None, inputs_embeds=None):
        if inputs_embeds is None:
            inputs_embeds = self.word_embeddings(input_ids)
        if position_ids is None:
            position_ids = torch.arange(inputs_embeds.shape[1], device=inputs_embeds.device)[None]
        return self.LayerNorm(inputs_embeds + self.position_embeddings(position_ids))


class DistilBertSelfAttention(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.n_heads = config.n_heads
        self.head_dim = config.dim // config.n_heads
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.q_lin = Linear(config.dim, config.dim, True, **kw)
        self.k_lin = Linear(config.dim, config.dim, True, **kw)
        self.v_lin = Linear(config.dim, config.dim, True, **kw)
        self.out_lin = Linear(config.dim, config.dim, True, **kw)

    def forward(self, hidden, attn_args):
        b, s, e = hidden.shape
        q = self.q_lin(hidden).reshape(b, s, self.n_heads, self.head_dim)
        k = self.k_lin(hidden).reshape(b, s, self.n_heads, self.head_dim)
        v = self.v_lin(hidden).reshape(b, s, self.n_heads, self.head_dim)
        attn_fn = get_attention_fn(self.config.attn_implementation)
        out = attn_fn(q, k, v, scale=self.head_dim ** -0.5, **attn_args)
        return self.out_lin(out.reshape(b, s, e))


class DistilBertFFN(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.lin1 = Linear(config.dim, config.hidden_dim, True, **kw)
        self.lin2 = Linear(config.hidden_dim, config.dim, True, **kw)
        self.act = get_activation(config.activation)

    def forward(self, x):
        return self.lin2(self.act(self.lin1(x)))


class DistilBertBlock(nn.Module):
    """Post-LN block (reference TransformerBlock :227)."""

    def __init__(self, config, **kw):
        super().__init__()
        self.attention = DistilBertSelfAttention(config, **kw)
        self.sa_layer_norm = LayerNorm(config.dim, LN_EPS, **kw)
        self.ffn = DistilBertFFN(config, **kw)
        self.output_layer_norm = LayerNorm(config.dim, LN_EPS, **kw)

    def forward(self, hidden, attn_args):
        hidden = self.sa_layer_norm(self.attention(hidden, attn_args) + hidden)
        return self.output_layer_norm(self.ffn(hidden) + hidden)


class DistilBertTransformer(nn.Module):
    def __init__(self, config, **kw):
        super().__init__()
        self.layer = nn.ModuleList([DistilBertBlock(config, **kw)
                                    for _ in range(config.n_layers)])

    def forward(self, hidden, attn_args, output_hidden_states=False):
        all_hidden = [] if output_hidden_states else None
        for block in self.layer:
            if output_hidden_states:
                all_hidden.append(hidden)
            hidden = block(hidden, attn_args)
        if output_hidden_states:
            all_hidden.append(hidden)
        return hidden, all_hidden


class DistilBertModel(nn.Module):
    def __init__(self, config: DistilBertConfig, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.embeddings = DistilBertEmbeddings(config, **kw)
        self.transformer = DistilBertTransformer(config, **kw)

    def forward(self, input_ids=None, attention_mask=None, position_ids=None,
                inputs_embeds=None, output_hidden_states: bool = False
                ) -> BaseModelOutputWithPooling:
        hidden = self.embeddings(input_ids, position_ids, inputs_embeds)
        b, s, _ = hidden.shape
        attn_args = encoder_attn_args(attention_mask, b, s, hidden.device)
        hidden, all_hidden = self.transformer(hidden, attn_args, output_hidden_states)
        return BaseModelOutputWithPooling(
            last_hidden_state=hidden, pooler_output=None,
            hidden_states=tuple(all_hidden) if all_hidden is not None else None)


class DistilBertPreTrainedModel(PreTrainedModel):
    config_class = DistilBertConfig
    base_model_prefix = "distilbert"

    def _encoder(self) -> DistilBertModel:
        return DistilBertModel(self.config, dtype=self.dtype, param_dtype=self.param_dtype,
                               device=self.device)

    def _linear(self, out_features: int) -> Linear:
        return Linear(self.config.dim, out_features, True, dtype=self.dtype,
                      param_dtype=self.param_dtype, device=self.device,
                      init_std=self.config.initializer_range)


class DistilBertModelStandalone(DistilBertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.distilbert = self._encoder()

    def forward(self, *args, **kwargs) -> BaseModelOutputWithPooling:
        return self.distilbert(*args, **kwargs)


class DistilBertForMaskedLM(DistilBertPreTrainedModel):
    _keys_to_ignore_on_load_unexpected = (r"vocab_projector\.weight", r"\.position_ids$")

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.distilbert = self._encoder()
        self.vocab_transform = self._linear(config.dim)
        self.vocab_layer_norm = LayerNorm(config.dim, LN_EPS, dtype=self.dtype,
                                          param_dtype=self.param_dtype, device=self.device)
        # the tied projector: the word-embedding table and a bias of its own
        self.vocab_projector = Bias(config.vocab_size, param_dtype=self.param_dtype,
                                    device=self.device)
        self.act = get_activation(config.activation)

    def forward(self, input_ids=None, attention_mask=None, labels=None,
                **kwargs) -> MaskedLMOutput:
        out = self.distilbert(input_ids, attention_mask, **kwargs)
        h = self.vocab_layer_norm(self.act(self.vocab_transform(out.last_hidden_state)))
        logits = self.distilbert.embeddings.word_embeddings.attend(h)
        logits = logits + self.vocab_projector.bias.to(logits.dtype)
        loss = (for_masked_lm_loss(logits, labels, self.config.vocab_size)
                if labels is not None else None)
        return MaskedLMOutput(loss=loss, logits=logits, hidden_states=out.hidden_states)


class DistilBertForSequenceClassification(DistilBertPreTrainedModel):
    """[CLS] -> ``pre_classifier`` -> ReLU -> ``classifier`` (reference :593)."""

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        self.distilbert = self._encoder()
        self.pre_classifier = self._linear(config.dim)
        self.classifier = self._linear(config.num_labels)

    def forward(self, input_ids=None, attention_mask=None, labels=None,
                **kwargs) -> SequenceClassifierOutput:
        out = self.distilbert(input_ids, attention_mask, **kwargs)
        pooled = torch.relu(self.pre_classifier(out.last_hidden_state[:, 0]))
        logits = self.classifier(pooled)
        loss = (for_sequence_classification_loss(logits, labels, self.config)
                if labels is not None else None)
        return SequenceClassifierOutput(loss=loss, logits=logits, hidden_states=out.hidden_states)


class DistilBertForQuestionAnswering(DistilBertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.distilbert = self._encoder()
        self.qa_outputs = self._linear(2)

    def forward(self, input_ids=None, attention_mask=None, start_positions=None,
                end_positions=None, **kwargs) -> QuestionAnsweringModelOutput:
        out = self.distilbert(input_ids, attention_mask, **kwargs)
        logits = self.qa_outputs(out.last_hidden_state)
        start_logits, end_logits = logits[..., 0], logits[..., 1]
        loss = None
        if start_positions is not None and end_positions is not None:
            loss = for_question_answering_loss(start_logits, end_logits, start_positions,
                                               end_positions)
        return QuestionAnsweringModelOutput(loss=loss, start_logits=start_logits,
                                            end_logits=end_logits,
                                            hidden_states=out.hidden_states)
