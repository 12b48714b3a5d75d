"""Cohere (Command-R) decoder (port of transformers_tpu/models/cohere/modeling_cohere.py;
reference src/transformers/models/cohere/modeling_cohere.py).

The Llama skeleton with Cohere's changes: a mean-centred LayerNorm with no
bias (:78), interleaved rope (:53, :97), optional head-wise q/k LayerNorms
with ``[heads, D]`` weights under ``use_qk_norm``, the parallel residual
``x + attn(ln(x)) + mlp(ln(x))`` with one norm (:82-91), and the logits
times ``logit_scale`` (:109) in ``compute_logits``, which every logits path
runs (a forward, the captured decode step, the continuous-batching
runner). Interleaved rope keeps static decode off K2, as in the JAX package.
"""

from __future__ import annotations

from ...core.module import HeadwiseLayerNorm, LayerNorm
from ...ops.rope import apply_rotary_pos_emb_interleaved, compute_cos_sin_interleaved
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_cohere import CohereConfig


class CohereAttention(LlamaAttention):
    rope_fn = staticmethod(apply_rotary_pos_emb_interleaved)

    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        if getattr(config, "use_qk_norm", False):
            kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
            self.q_norm = HeadwiseLayerNorm(self.num_heads, self.head_dim,
                                            config.layer_norm_eps, **kw)
            self.k_norm = HeadwiseLayerNorm(self.num_kv_heads, self.head_dim,
                                            config.layer_norm_eps, **kw)


class CohereDecoderLayer(LlamaDecoderLayer):
    """One norm, the parallel residual."""

    attention_cls = CohereAttention

    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        del self.post_attention_layernorm

    @staticmethod
    def make_norm(config, **kw):
        return LayerNorm(config.hidden_size, config.layer_norm_eps, use_bias=False, **kw)

    def forward(self, hidden, cos, sin, attn_args, cache, cache_position):
        h = self.input_layernorm(hidden)
        attn = self.self_attn(h, cos, sin, attn_args, cache, cache_position)
        return hidden + attn + self.mlp(h)


class CohereModel(LlamaModel):
    decoder_layer_cls = CohereDecoderLayer

    def compute_rope(self, position_ids):
        return compute_cos_sin_interleaved(position_ids, self.inv_freq, self.attention_scaling,
                                           dtype=self.dtype)


class CohereForCausalLM(LlamaForCausalLM):
    config_class = CohereConfig
    model_cls = CohereModel

    def compute_logits(self, hidden):
        return super().compute_logits(hidden) * self.config.logit_scale


class CohereModelStandalone(LlamaModelStandalone):
    config_class = CohereConfig
    model_cls = CohereModel
