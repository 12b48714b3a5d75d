"""Llama decoder in PyTorch: the decoder skeleton of the port.

Port of ``transformers_tpu/models/llama/modeling_llama.py`` (reference
src/transformers/models/llama/modeling_llama.py: RMSNorm :53, rotary
:73/:138, gated MLP :163, GQA attention :217-283, DecoderLayer :284, Model
:347, ForCausalLM :421). BSHD attention layout, masks as data, f32 softmax
and norms. Subclass hooks are kept as in the JAX skeleton
(``build_projections``, ``project_qkv``, ``post_rope_qk``, ``rope_fn``,
``extra_attn_kwargs``, ``q_norm``/``k_norm``, ``compute_rope``/``rope_for_layer``,
``embed``).

Attention routing: a static prefill (``cache_position`` the int 0, S > 1)
attends over the local k/v through the registry, whose default is the flash
kernel (ops/flash_attention.py); a single-token step over the static cache
goes through the fused decode kernel (ops/fused_decode.py) whenever the
family uses plain rotate-half rope and the shapes fit, at every batch size;
any other step over the static cache, and every step over the int8 cache
(``QuantizedKVCache``, dequantized by its ``layer``, as in the JAX package),
takes ``cached_attention_bhsd``. A
static decode step's ``cache_position`` is the int slot or, in a decode loop
on the device, the cache's one-element slot tensor, which no step reads back.

Over a paged cache (continuous batching, ``layout == "paged"``), where
``cache_position`` is a per-row tensor ([1, 1] for a prefill chunk, [N, 1]
in decode): a single-token step goes through the paged decode kernel
(ops/paged_attention.py) when the shapes fit and there is no softcap or
sink; anything else, chunked prefill included, attends over the gathered
context through the registry (the flash kernel by default).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...cache_utils import StaticKVCache, cache_from_config, layer_sliding_window
from ...core.module import Embedding, Linear, RMSNorm
from ...generation.utils import GenerationMixin
from ...loss import for_causal_lm_loss
from ...modeling_outputs import BaseModelOutputWithPast, CausalLMOutputWithPast
from ...modeling_utils import PreTrainedModel
from ...ops.activations import get_activation
from ...ops.attention import cached_attention_bhsd, get_attention_fn
from ...ops.fused_decode import fused_decode_attention, fused_decode_supported
from ...ops.masks import segment_ids_from_position_ids
from ...ops.paged_attention import paged_decode_attention, paged_decode_supported
from ...ops.rope import apply_rotary_pos_emb, compute_cos_sin, rope_inv_freq
from .configuration_llama import LlamaConfig


class LlamaMLP(nn.Module):
    """Gated SwiGLU MLP (reference modeling_llama.py:163)."""

    def __init__(self, config, *, dtype, param_dtype, device, intermediate_size=None):
        super().__init__()
        bias = getattr(config, "mlp_bias", False)
        inner = intermediate_size or config.intermediate_size
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.gate_proj = Linear(config.hidden_size, inner, bias, **kw)
        self.up_proj = Linear(config.hidden_size, inner, bias, **kw)
        self.down_proj = Linear(inner, config.hidden_size, bias, **kw)
        self.act_fn = get_activation(getattr(config, "hidden_activation", None)
                                     or config.hidden_act)

    def forward(self, x):
        return self.down_proj(self.act_fn(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    """GQA attention with registry dispatch (reference modeling_llama.py:217-283).

    Config knobs subclasses rely on: ``attention_qkv_bias`` /
    ``attention_o_bias`` (falling back to ``attention_bias``), per-layer
    sliding windows (``layer_sliding_window``), ``attn_logit_softcapping``,
    ``query_pre_attn_scalar``, and the ``q_norm``/``k_norm`` hooks."""

    # rope application style: interleaved-rope families swap this
    rope_fn = staticmethod(apply_rotary_pos_emb)

    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        self.dtype = dtype
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = (getattr(config, "num_key_value_heads", None)
                             or config.num_attention_heads)
        self.head_dim = (getattr(config, "head_dim", None)
                         or config.hidden_size // config.num_attention_heads)
        scalar = getattr(config, "query_pre_attn_scalar", None)
        self.scale = (scalar ** -0.5) if scalar else self.head_dim ** -0.5
        self.sliding_window = layer_sliding_window(config, layer_idx)
        self.logit_cap = getattr(config, "attn_logit_softcapping", None)
        bias = getattr(config, "attention_bias", False)
        qkv_bias = getattr(config, "attention_qkv_bias", None)
        o_bias = getattr(config, "attention_o_bias", None)
        qkv_bias = bias if qkv_bias is None else qkv_bias
        o_bias = bias if o_bias is None else o_bias
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.build_projections(config, qkv_bias, o_bias, kw)
        self.q_norm: Optional[nn.Module] = None
        self.k_norm: Optional[nn.Module] = None

    def build_projections(self, config, qkv_bias, o_bias, kw):
        """Separate q/k/v/o projections; fused-checkpoint families override."""
        self.q_proj = Linear(config.hidden_size, self.num_heads * self.head_dim, qkv_bias, **kw)
        self.k_proj = Linear(config.hidden_size, self.num_kv_heads * self.head_dim, qkv_bias, **kw)
        self.v_proj = Linear(config.hidden_size, self.num_kv_heads * self.head_dim, qkv_bias, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, config.hidden_size, o_bias, **kw)

    def project_qkv(self, hidden):
        """Split projections; subclasses with fused checkpoints override."""
        b, s, _ = hidden.shape
        q = self.q_proj(hidden).reshape(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(hidden).reshape(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(hidden).reshape(b, s, self.num_kv_heads, self.head_dim)
        return q, k, v

    def project_out(self, out):
        return self.o_proj(out)

    def extra_attn_kwargs(self) -> dict:
        """Extra kwargs for the attention function derived from this module's
        parameters (e.g. GPT-OSS learned sink logits)."""
        return {}

    def post_rope_qk(self, q, k):
        """Hook applied to q/k after rope (HunYuan post-rope head norms)."""
        return q, k

    def _fused_decode(self, q, k, v, cos, sin, kwargs, cache, cache_position):
        """The single-token step through the fused decode kernel, when the
        family uses plain rotate-half rope and a static cache; returns the
        attention output [B, 1, H, D], or None to take the unfused path."""
        cls = type(self)
        if (not isinstance(cache, StaticKVCache)
                or q.shape[1] != 1
                or cos is None
                or not getattr(self, "apply_rope", True)
                or cls.rope_fn is not LlamaAttention.rope_fn
                or cls.post_rope_qk is not LlamaAttention.post_rope_qk
                or cos.shape[-1] != self.head_dim
                or kwargs.get("logit_cap") is not None
                or kwargs.get("sinks") is not None
                or kwargs.get("probs_sink") is not None
                or not kwargs.get("is_causal", True)):
            return None
        k_cache, v_cache = cache.layer(self.layer_idx)
        kv_valid = kwargs.get("kv_valid")
        if (kv_valid is None or k_cache.dtype != self.dtype
                or not fused_decode_supported(q, k_cache)):
            return None
        # the step's slot on the device: never read back, so a captured graph
        # of the step replays at whatever slot the tensor holds
        pos = cache.slot_tensor(cache_position)
        # first live slot: the first valid one (0 for an all-zero row), moved
        # up to the window's start on sliding layers
        start = kv_valid.ne(0).to(torch.int32).argmax(dim=-1)
        if self.sliding_window is not None:
            start = torch.maximum(start, pos + (1 - self.sliding_window))
        return fused_decode_attention(q, k, v, cos, sin, k_cache, v_cache, pos, start, kv_valid,
                                      scale=float(self.scale))

    def _paged_decode_ok(self, q, kwargs, cache) -> bool:
        """True when a step over a paged cache takes the paged decode kernel:
        one token per row, no softcap, sink or probabilities asked for, and
        pools of q's dtype in a shape the kernel takes."""
        if (getattr(cache, "layout", None) != "paged" or q.shape[1] != 1
                or kwargs.get("logit_cap") is not None
                or kwargs.get("sinks") is not None
                or kwargs.get("probs_sink") is not None):
            return False
        k_pool = cache.paged_layer(self.layer_idx)[0]
        return k_pool.dtype == q.dtype and paged_decode_supported(q, k_pool)

    def forward(self, hidden: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                attn_args: dict[str, Any], cache, cache_position) -> torch.Tensor:
        b, s, _ = hidden.shape
        q, k, v = self.project_qkv(hidden)
        if self.q_norm is not None:
            q = self.q_norm(q)
        if self.k_norm is not None:
            k = self.k_norm(k)

        kwargs = dict(attn_args)
        kwargs["sliding_window"] = self.sliding_window
        kwargs["logit_cap"] = self.logit_cap
        kwargs.update(self.extra_attn_kwargs())

        out = self._fused_decode(q, k, v, cos, sin, kwargs, cache, cache_position)
        if out is None:
            if cos is not None and getattr(self, "apply_rope", True):
                q, k = self.rope_fn(q, k, cos, sin)
            q, k = self.post_rope_qk(q, k)
            # Static prefill (cache_position is the int 0): attend over the
            # just-computed local k/v; the cache holds nothing else yet.
            is_static_prefill = (cache is not None and s > 1
                                 and isinstance(cache_position, int) and cache_position == 0)
            if cache is not None:
                cache.update(self.layer_idx, k, v, cache_position)
            if cache is None or is_static_prefill:
                if is_static_prefill and kwargs.get("kv_valid") is not None:
                    kwargs["kv_valid"] = kwargs["kv_valid"][:, :s]
                attn_fn = get_attention_fn(self.config.attn_implementation)
                out = attn_fn(q, k, v, scale=self.scale, **kwargs)
            elif self._paged_decode_ok(q, kwargs, cache):
                # continuous-batching decode: pages read through the block
                # tables, no gather (the new token's k/v are in the pool)
                k_pool, v_pool, tables, ctx_lens = cache.paged_layer(self.layer_idx)
                out = paged_decode_attention(q, k_pool, v_pool, tables, ctx_lens,
                                             scale=float(self.scale),
                                             sliding_window=self.sliding_window)
            elif getattr(cache, "layout", None) == "paged":
                # chunked prefill (and decode shapes the kernel does not
                # take): the gathered context through the registry
                k_full, v_full = cache.layer(self.layer_idx)
                attn_fn = get_attention_fn(self.config.attn_implementation)
                out = attn_fn(q, k_full.to(self.dtype), v_full.to(self.dtype),
                              scale=self.scale, **kwargs)
            else:
                k_full, v_full = cache.layer(self.layer_idx)
                out = cached_attention_bhsd(q, k_full.to(self.dtype), v_full.to(self.dtype),
                                            scale=self.scale, **kwargs)
        return self.project_out(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaDecoderLayer(nn.Module):
    """Pre-norm residual block (reference modeling_llama.py:284)."""

    attention_cls = LlamaAttention
    mlp_cls = LlamaMLP
    # checkpoint name of the feed-forward block (Mixtral's "block_sparse_moe")
    mlp_name = "mlp"

    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        self.input_layernorm = self.make_norm(config, **kw)
        self.self_attn = self.attention_cls(config, layer_idx, **kw)
        self.post_attention_layernorm = self.make_norm(config, **kw)
        setattr(self, self.mlp_name, self.make_mlp(config, layer_idx, **kw))

    @staticmethod
    def make_norm(config, **kw):
        return RMSNorm(config.hidden_size, config.rms_norm_eps, **kw)

    def make_mlp(self, config, layer_idx: int, **kw) -> nn.Module:
        """The feed-forward block; the mixture-of-experts families choose a
        sparse or a dense one per layer."""
        return self.mlp_cls(config, **kw)

    def forward(self, hidden, cos, sin, attn_args, cache, cache_position):
        h = self.self_attn(self.input_layernorm(hidden), cos, sin, attn_args, cache,
                           cache_position)
        hidden = hidden + h
        return hidden + getattr(self, self.mlp_name)(self.post_attention_layernorm(hidden))


class LlamaModel(nn.Module):
    """Bare transformer (reference modeling_llama.py:347)."""

    decoder_layer_cls = LlamaDecoderLayer
    # scale inputs_embeds by sqrt(hidden) (Gemma family)
    scale_embeddings: bool = False
    # checkpoint name of the final norm ("final_layernorm" for Phi)
    norm_name: str = "norm"
    # prefix-LM inference: queries attend to every valid kv slot when False
    causal_attention: bool = True

    def __init__(self, config: LlamaConfig, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.dtype = dtype
        # recompute each decoder layer's forward in the backward pass instead
        # of keeping its activations (PreTrainedModel.gradient_checkpointing_enable)
        self.gradient_checkpointing = False
        self.embed_tokens = Embedding(config.vocab_size, config.hidden_size, dtype=dtype,
                                      param_dtype=param_dtype, device=device,
                                      init_std=config.initializer_range)
        self.layers = nn.ModuleList([
            self.decoder_layer_cls(config, i, dtype=dtype, param_dtype=param_dtype, device=device)
            for i in range(config.num_hidden_layers)])
        setattr(self, self.norm_name, self.decoder_layer_cls.make_norm(
            config, dtype=dtype, param_dtype=param_dtype, device=device))
        inv_freq, self.attention_scaling = rope_inv_freq(config)
        self.register_buffer("inv_freq", torch.as_tensor(inv_freq, dtype=torch.float32,
                                                         device=device), persistent=False)
        # Gemma's sqrt(hidden), rounded to the compute dtype once here: a
        # Python float, so no forward makes or copies a tensor for it (the
        # decode step is captured as a CUDA graph, where a host copy is a sync)
        self._embed_scale = float(torch.tensor(config.hidden_size ** 0.5, dtype=dtype))

    def compute_rope(self, position_ids):
        """(cos, sin) tables for every layer; Gemma3 overrides with a
        (global, local) pair selected per layer type."""
        return compute_cos_sin(position_ids, self.inv_freq, self.attention_scaling,
                               dtype=self.dtype)

    def rope_for_layer(self, rope, layer_idx):
        return rope

    def embed_scale(self) -> float:
        """Gemma multiplies embeddings by sqrt(hidden) rounded to the compute
        dtype (reference models/gemma/modeling_gemma.py ``normalizer``)."""
        return self._embed_scale

    def embed(self, input_ids):
        """Token embedding hook; families with extra embedding-stage work override."""
        inputs_embeds = self.embed_tokens(input_ids)
        if self.scale_embeddings:
            inputs_embeds = inputs_embeds * self.embed_scale()
        return inputs_embeds

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                past_key_values=None, cache_position=0,
                inputs_embeds: Optional[torch.Tensor] = None, output_hidden_states: bool = False,
                output_attentions: bool = False) -> BaseModelOutputWithPast:
        hidden = self.embed(input_ids) if inputs_embeds is None else inputs_embeds
        b, s, _ = hidden.shape
        dev = hidden.device

        explicit_positions = position_ids is not None
        if position_ids is None:
            # positions from cache_position, not from the mask: callers with
            # padded batches pass explicit position_ids, as generate() does.
            # cache_position is an int or a per-row [B, 1] tensor (paged).
            position_ids = (torch.arange(s, device=dev) + cache_position).expand(b, s)
        rope = self.compute_rope(position_ids)

        kv_len = past_key_values.max_len if past_key_values is not None else s
        q_positions = (torch.arange(s, device=dev) + cache_position).to(torch.int32).expand(b, s)
        kv_valid = (attention_mask.to(torch.int32) if attention_mask is not None
                    else torch.ones((b, kv_len), dtype=torch.int32, device=dev))
        attn_args = {"q_positions": q_positions, "kv_valid": kv_valid,
                     "is_causal": self.causal_attention, "sliding_window": None}
        if (past_key_values is None and explicit_positions
                and self.causal_attention and position_ids.ndim == 2):
            # packed-sequence rows: position resets mark sequence boundaries
            # (reference masking_utils.py:159); a plain arange is one segment
            seg = segment_ids_from_position_ids(position_ids)
            attn_args["q_segment_ids"] = seg
            attn_args["kv_segment_ids"] = seg
        # output_attentions channel: the eager path appends [B, H, Q, KV] probs
        probs_sink = [] if output_attentions else None
        if output_attentions:
            attn_args["probs_sink"] = probs_sink

        all_hidden = [] if output_hidden_states else None
        for i, layer in enumerate(self.layers):
            if output_hidden_states:
                all_hidden.append(hidden)
            cos, sin = self.rope_for_layer(rope, i)
            if self.gradient_checkpointing and torch.is_grad_enabled():
                hidden = checkpoint(layer, hidden, cos, sin, attn_args, past_key_values,
                                    cache_position, use_reentrant=False)
            else:
                hidden = layer(hidden, cos, sin, attn_args, past_key_values, cache_position)
        hidden = getattr(self, self.norm_name)(hidden)
        if output_hidden_states:
            all_hidden.append(hidden)
        return BaseModelOutputWithPast(
            last_hidden_state=hidden, past_key_values=past_key_values,
            hidden_states=tuple(all_hidden) if all_hidden is not None else None,
            attentions=tuple(probs_sink) if probs_sink is not None else None)


class LlamaPreTrainedModel(PreTrainedModel):
    config_class = LlamaConfig
    base_model_prefix = "model"


class LlamaForCausalLM(LlamaPreTrainedModel, GenerationMixin):
    """Reference modeling_llama.py:421."""

    model_cls = LlamaModel

    def __init__(self, config: LlamaConfig, *, dtype=torch.float32, param_dtype=None,
                 device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        self.model = self.model_cls(config, dtype=self.dtype, param_dtype=self.param_dtype,
                                    device=self.device)
        # tied word embeddings: logits come from embed_tokens.attend and no
        # lm_head parameter exists at all
        if not config.tie_word_embeddings:
            self.lm_head = Linear(config.hidden_size, config.vocab_size, False, dtype=self.dtype,
                                  param_dtype=self.param_dtype, device=self.device,
                                  init_std=config.initializer_range)

    def compute_logits(self, hidden):
        if self.config.tie_word_embeddings:
            logits = self.model.embed_tokens.attend(hidden)
        else:
            logits = self.lm_head(hidden)
        cap = getattr(self.config, "final_logit_softcapping", None)
        if cap:
            logits = torch.tanh(logits / cap) * cap
        return logits

    def forward(self, input_ids: Optional[torch.Tensor] = None,
                attention_mask: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                past_key_values=None, cache_position=0,
                inputs_embeds: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None, logits_to_keep: int = 0,
                output_hidden_states: bool = False, output_attentions: bool = False, *,
                shift_labels: Optional[torch.Tensor] = None) -> CausalLMOutputWithPast:
        """With ``labels`` (shifted by one here) or ``shift_labels`` (already
        shifted), also the mean cross-entropy over labels that are not -100."""
        outputs = self.model(input_ids, attention_mask, position_ids, past_key_values,
                             cache_position, inputs_embeds, output_hidden_states,
                             output_attentions)
        hidden = outputs.last_hidden_state
        if logits_to_keep:
            hidden = hidden[:, -logits_to_keep:, :]
        logits = self.compute_logits(hidden)
        loss = None
        if labels is not None or shift_labels is not None:
            loss = for_causal_lm_loss(logits, labels, self.config.vocab_size,
                                      shift_labels=shift_labels)
        return CausalLMOutputWithPast(
            loss=loss, logits=logits, past_key_values=outputs.past_key_values,
            hidden_states=outputs.hidden_states, attentions=outputs.attentions)

    def init_cache(self, batch_size: int, max_len: int, dtype=None,
                   implementation: str = "static"):
        """A bhsd cache: the static one, or the int8 one for ``implementation``
        "quantized"."""
        return cache_from_config(self.config, batch_size, max_len, dtype or self.dtype,
                                 device=self.device, implementation=implementation)
