"""ModernBERT in PyTorch (port of
``transformers_tpu/models/modernbert/modeling_modernbert.py``; reference
src/transformers/models/modernbert/modeling_modernbert.py).

No position embeddings: rope with a different theta on global and local
layers (:94-128), on ``ops/rope.py``; layers alternate by
``global_attn_every_n_layers`` (``config.layer_types``). A local layer
attends within the inclusive bidirectional window ``|q - slot| <=
local_attention // 2``, which the flash kernel does not take (its window is
one-sided), so it runs the eager path in both packages; a global layer goes
through the flash kernel's bidirectional mode on the card. A fused ``Wqkv``
packed [.., 3, H, D] (:246-275); the GeGLU MLP ``act(input) * gate`` with
the input half first (:84-91); pre-norm layers with the layer-0
``attn_norm`` removed (Identity, :309-312); ``final_norm`` (:420); the MLM
head dense -> act -> norm -> the tied decoder (the token-embedding table)
plus ``decoder.bias`` (:481-506); ``cls`` / ``mean`` classifier pooling
(:609-611).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...core.module import Bias, Embedding, LayerNorm, Linear
from ...loss import (for_masked_lm_loss, for_sequence_classification_loss,
                     for_token_classification_loss)
from ...modeling_outputs import (BaseModelOutputWithPooling, MaskedLMOutput,
                                 SequenceClassifierOutput, TokenClassifierOutput)
from ...modeling_utils import PreTrainedModel
from ...ops.activations import get_activation
from ...ops.attention import get_attention_fn
from ...ops.rope import apply_rotary_pos_emb, compute_cos_sin
from .configuration_modernbert import ModernBertConfig


def _linear_kw(config, dtype, param_dtype, device) -> dict:
    return dict(dtype=dtype, param_dtype=param_dtype, device=device,
                init_std=config.initializer_range)


def _norm(config, dtype, param_dtype, device) -> LayerNorm:
    return LayerNorm(config.hidden_size, config.norm_eps, use_bias=config.norm_bias,
                     dtype=dtype, param_dtype=param_dtype, device=device)


class ModernBertEmbeddings(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.tok_embeddings = Embedding(config.vocab_size, config.hidden_size,
                                        **_linear_kw(config, dtype, param_dtype, device))
        self.norm = _norm(config, dtype, param_dtype, device)

    def forward(self, input_ids, inputs_embeds=None):
        if inputs_embeds is None:
            inputs_embeds = self.tok_embeddings(input_ids)
        return self.norm(inputs_embeds)


class ModernBertAttention(nn.Module):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.num_heads = config.num_attention_heads
        self.head_dim = config.hidden_size // config.num_attention_heads
        self.sliding_window = (config.sliding_window
                               if config.layer_types[layer_idx] == "sliding_attention" else None)
        kw = _linear_kw(config, dtype, param_dtype, device)
        self.Wqkv = Linear(config.hidden_size, 3 * config.hidden_size, config.attention_bias,
                           **kw)
        self.Wo = Linear(config.hidden_size, config.hidden_size, config.attention_bias, **kw)

    def forward(self, hidden, cos, sin, kv_valid):
        b, s, e = hidden.shape
        qkv = self.Wqkv(hidden).reshape(b, s, 3, self.num_heads, self.head_dim)
        q, k = apply_rotary_pos_emb(qkv[:, :, 0], qkv[:, :, 1], cos, sin)
        # the kernel reads whole [B, S, H, D] tensors
        q, k, v = q.contiguous(), k.contiguous(), qkv[:, :, 2].contiguous()
        attn_fn = get_attention_fn(self.config.attn_implementation)
        out = attn_fn(q, k, v, scale=self.head_dim ** -0.5, kv_valid=kv_valid,
                      is_causal=False, sliding_window=self.sliding_window)
        return self.Wo(out.reshape(b, s, e))


class ModernBertMLP(nn.Module):
    """GeGLU with the input half first: act(input) * gate (reference :90)."""

    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        kw = _linear_kw(config, dtype, param_dtype, device)
        self.Wi = Linear(config.hidden_size, config.intermediate_size * 2, config.mlp_bias, **kw)
        self.Wo = Linear(config.intermediate_size, config.hidden_size, config.mlp_bias, **kw)
        self.act = get_activation(config.hidden_activation)

    def forward(self, x):
        inp, gate = self.Wi(x).chunk(2, dim=-1)
        return self.Wo(self.act(inp) * gate)


class ModernBertEncoderLayer(nn.Module):
    def __init__(self, config, layer_idx: int, **kw):
        super().__init__()
        self.first = layer_idx == 0
        if not self.first:  # layer 0's attn_norm is the identity
            self.attn_norm = _norm(config, **kw)
        self.attn = ModernBertAttention(config, layer_idx, **kw)
        self.mlp_norm = _norm(config, **kw)
        self.mlp = ModernBertMLP(config, **kw)

    def forward(self, hidden, cos, sin, kv_valid):
        h = hidden if self.first else self.attn_norm(hidden)
        hidden = hidden + self.attn(h, cos, sin, kv_valid)
        return hidden + self.mlp(self.mlp_norm(hidden))


def _inv_freq(theta: float, head_dim: int) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))


class ModernBertModel(nn.Module):
    def __init__(self, config: ModernBertConfig, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.dtype = dtype
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.embeddings = ModernBertEmbeddings(config, **kw)
        self.layers = nn.ModuleList([ModernBertEncoderLayer(config, i, **kw)
                                     for i in range(config.num_hidden_layers)])
        self.final_norm = _norm(config, **kw)
        head_dim = config.hidden_size // config.num_attention_heads
        self.inv_freq = {"full_attention": _inv_freq(config.global_rope_theta, head_dim),
                         "sliding_attention": _inv_freq(config.local_rope_theta, head_dim)}

    def forward(self, input_ids=None, attention_mask=None, position_ids=None,
                inputs_embeds=None, output_hidden_states: bool = False
                ) -> BaseModelOutputWithPooling:
        hidden = self.embeddings(input_ids, inputs_embeds)
        b, s, _ = hidden.shape
        if position_ids is None:
            position_ids = torch.arange(s, device=hidden.device).expand(b, s)
        ropes = {kind: compute_cos_sin(position_ids, inv, dtype=self.dtype)
                 for kind, inv in self.inv_freq.items()}
        kv_valid = (attention_mask.to(torch.int32) if attention_mask is not None
                    else torch.ones((b, s), dtype=torch.int32, device=hidden.device))
        all_hidden = [] if output_hidden_states else None
        for i, layer in enumerate(self.layers):
            if output_hidden_states:
                all_hidden.append(hidden)
            cos, sin = ropes[self.config.layer_types[i]]
            hidden = layer(hidden, cos, sin, kv_valid)
        hidden = self.final_norm(hidden)
        if output_hidden_states:
            all_hidden.append(hidden)
        return BaseModelOutputWithPooling(
            last_hidden_state=hidden, pooler_output=None,
            hidden_states=tuple(all_hidden) if all_hidden is not None else None)


class ModernBertPreTrainedModel(PreTrainedModel):
    config_class = ModernBertConfig
    base_model_prefix = "model"

    def _encoder(self) -> ModernBertModel:
        return ModernBertModel(self.config, dtype=self.dtype, param_dtype=self.param_dtype,
                               device=self.device)

    def _head(self) -> "ModernBertPredictionHead":
        return ModernBertPredictionHead(self.config, dtype=self.dtype,
                                        param_dtype=self.param_dtype, device=self.device)

    def _classifier(self) -> Linear:
        return Linear(self.config.hidden_size, self.config.num_labels, True,
                      **_linear_kw(self.config, self.dtype, self.param_dtype, self.device))


class ModernBertModelStandalone(ModernBertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.model = self._encoder()

    def forward(self, *args, **kwargs) -> BaseModelOutputWithPooling:
        return self.model(*args, **kwargs)


class ModernBertPredictionHead(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        self.dense = Linear(config.hidden_size, config.hidden_size, config.classifier_bias,
                            **_linear_kw(config, dtype, param_dtype, device))
        self.norm = _norm(config, dtype, param_dtype, device)
        self.act = get_activation(config.classifier_activation)

    def forward(self, x):
        return self.norm(self.act(self.dense(x)))


class ModernBertForMaskedLM(ModernBertPreTrainedModel):
    _keys_to_ignore_on_load_unexpected = (r"^decoder\.weight$",)

    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.model = self._encoder()
        self.head = self._head()
        # the tied decoder: the token-embedding table, and a bias of its own
        if config.decoder_bias:
            self.decoder = Bias(config.vocab_size, param_dtype=self.param_dtype,
                                device=self.device)

    def forward(self, input_ids=None, attention_mask=None, labels=None,
                **kwargs) -> MaskedLMOutput:
        out = self.model(input_ids, attention_mask, **kwargs)
        logits = self.model.embeddings.tok_embeddings.attend(self.head(out.last_hidden_state))
        if self.config.decoder_bias:
            logits = logits + self.decoder.bias.to(logits.dtype)
        loss = (for_masked_lm_loss(logits, labels, self.config.vocab_size)
                if labels is not None else None)
        return MaskedLMOutput(loss=loss, logits=logits, hidden_states=out.hidden_states)


class ModernBertForSequenceClassification(ModernBertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        self.model = self._encoder()
        self.head = self._head()
        self.classifier = self._classifier()

    def forward(self, input_ids=None, attention_mask=None, labels=None,
                **kwargs) -> SequenceClassifierOutput:
        out = self.model(input_ids, attention_mask, **kwargs)
        hidden = out.last_hidden_state
        if self.config.classifier_pooling == "mean":
            if attention_mask is None:
                pooled = hidden.mean(1)
            else:
                m = attention_mask[..., None].to(hidden.dtype)
                pooled = (hidden * m).sum(1) / m.sum(1).clamp_min(1.0)
        else:
            pooled = hidden[:, 0]
        logits = self.classifier(self.head(pooled))
        loss = (for_sequence_classification_loss(logits, labels, self.config)
                if labels is not None else None)
        return SequenceClassifierOutput(loss=loss, logits=logits, hidden_states=out.hidden_states)


class ModernBertForTokenClassification(ModernBertPreTrainedModel):
    def __init__(self, config, *, dtype=torch.float32, param_dtype=None, device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.num_labels = config.num_labels
        self.model = self._encoder()
        self.head = self._head()
        self.classifier = self._classifier()

    def forward(self, input_ids=None, attention_mask=None, labels=None,
                **kwargs) -> TokenClassifierOutput:
        out = self.model(input_ids, attention_mask, **kwargs)
        logits = self.classifier(self.head(out.last_hidden_state))
        loss = (for_token_classification_loss(logits, labels, self.config)
                if labels is not None else None)
        return TokenClassifierOutput(loss=loss, logits=logits, hidden_states=out.hidden_states)
