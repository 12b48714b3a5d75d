"""DeepSeek-V2 decoder (port of transformers_tpu/models/deepseek_v2/modeling_deepseek_v2.py;
reference src/transformers/models/deepseek_v2/modular_deepseek_v2.py).

DeepSeek-V3's multi-head latent attention and latent cache with V2's rope:
a complex product per interleaved pair whose output keeps the pairs
interleaved (``apply_rope_complex_pairs``), and the plain
``qk_head_dim ** -0.5`` scale (yarn's attention factor rides on the
tables). The router (``mlp.gate.weight``, the hub's ``[E, H]``, kept in
float32 as the JAX package keeps it): softmax of the float32 logits, the
top k of all experts (``greedy``) or of the ``topk_group`` groups with the
largest expert score (``group_limited_greedy``; the other groups' scores
set to 0), times ``routed_scaling_factor``, not renormalized. Shared
experts add to the routed output; layers below ``first_k_dense_replace``
are dense.
"""

from __future__ import annotations

import torch

from ...ops.moe import _top_k
from ...ops.rope import apply_rope_complex_pairs
from ..deepseek_v3.modeling_deepseek_v3 import (
    DeepseekV3Attention,
    DeepseekV3DecoderLayer,
    DeepseekV3ForCausalLM,
    DeepseekV3MoE,
)
from ..llama.modeling_llama import LlamaModel, LlamaModelStandalone
from .configuration_deepseek_v2 import DeepseekV2Config


class DeepseekV2Attention(DeepseekV3Attention):
    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__(config, layer_idx, dtype=dtype, param_dtype=param_dtype, device=device)
        self.scale = self.qk_head_dim ** -0.5

    def apply_mla_rope(self, q_rot, k_rot, cos, sin):
        return (apply_rope_complex_pairs(q_rot, cos, sin),
                apply_rope_complex_pairs(k_rot[:, :, None], cos, sin)[:, :, 0])


def deepseek_v2_route(scores: torch.Tensor, *, top_k: int, topk_method: str, n_group, topk_group,
                      routed_scaling_factor: float) -> tuple[torch.Tensor, torch.Tensor]:
    """V2's routing over the softmax scores [T, E] (JAX
    ``modeling_deepseek_v2.py:80-105``). Returns (weights [T, k], indices [T, k])."""
    if topk_method == "group_limited_greedy":
        t, e = scores.shape
        group_idx = _top_k(scores.reshape(t, n_group, e // n_group).amax(-1), topk_group)[1]
        allowed = torch.zeros((t, n_group), dtype=torch.bool, device=scores.device)
        allowed.scatter_(1, group_idx, True)
        scores = scores.masked_fill(~allowed.repeat_interleave(e // n_group, dim=-1), 0.0)
    weights, idx = _top_k(scores, top_k)
    return weights * routed_scaling_factor, idx


class DeepseekV2Moe(DeepseekV3MoE):
    correction_bias = False
    float32_gate = True

    def route(self, x):
        cfg = self.config
        return deepseek_v2_route(torch.softmax(self.gate(x), dim=-1), top_k=self.top_k,
                                 topk_method=cfg.topk_method, n_group=cfg.n_group,
                                 topk_group=cfg.topk_group,
                                 routed_scaling_factor=cfg.routed_scaling_factor)


class DeepseekV2DecoderLayer(DeepseekV3DecoderLayer):
    attention_cls = DeepseekV2Attention
    moe_cls = DeepseekV2Moe


class DeepseekV2Model(LlamaModel):
    decoder_layer_cls = DeepseekV2DecoderLayer


class DeepseekV2ForCausalLM(DeepseekV3ForCausalLM):
    config_class = DeepseekV2Config
    model_cls = DeepseekV2Model


class DeepseekV2ModelStandalone(LlamaModelStandalone):
    config_class = DeepseekV2Config
    model_cls = DeepseekV2Model
