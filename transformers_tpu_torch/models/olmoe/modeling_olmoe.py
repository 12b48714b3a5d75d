"""OLMoE decoder (port of transformers_tpu/models/olmoe/modeling_olmoe.py;
reference src/transformers/models/olmoe/modeling_olmoe.py).

The Llama skeleton with OLMo-2's RMSNorms over the full width of the q and
k projections (``hidden`` and ``kvh·D``), applied after ``clip_qkv`` and
before the head reshape, under the checkpoint's names ``self_attn.q_norm`` /
``k_norm`` (the JAX package calls them ``full_q_norm`` / ``full_k_norm``;
``convert.params_from_jax`` maps them). Each layer's feed-forward is the
routed experts of ``ops/moe.py``: softmax then top-k, renormalized when
``norm_topk_prob`` (not for OLMoE-1B-7B).
"""

from __future__ import annotations

from ...ops.moe import SparseMoeBlock
from ..llama.modeling_llama import (
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaModelStandalone,
)
from ..olmo2.modeling_olmo2 import Olmo2Attention
from .configuration_olmoe import OlmoeConfig


class OlmoeAttention(Olmo2Attention):
    """OLMo-2's attention; OLMoE's config adds ``clip_qkv``."""


class OlmoeSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: OlmoeConfig, *, dtype, param_dtype, device):
        super().__init__(config, config.num_experts, config.intermediate_size,
                         config.norm_topk_prob, dtype=dtype, param_dtype=param_dtype,
                         device=device)


class OlmoeDecoderLayer(LlamaDecoderLayer):
    attention_cls = OlmoeAttention
    mlp_cls = OlmoeSparseMoeBlock


class OlmoeModel(LlamaModel):
    decoder_layer_cls = OlmoeDecoderLayer


class OlmoeForCausalLM(LlamaForCausalLM):
    config_class = OlmoeConfig
    model_cls = OlmoeModel


class OlmoeModelStandalone(LlamaModelStandalone):
    config_class = OlmoeConfig
    model_cls = OlmoeModel
