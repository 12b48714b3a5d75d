"""Mistral4 decoder (port of transformers_tpu/models/mistral4/modeling_mistral4.py;
reference models/mistral4/modular_mistral4.py).

DeepSeek-V3's multi-head latent attention with llama-4's attention
temperature on the rotated queries: ``q * (1 + beta * log1p(floor(pos /
original_max_position_embeddings)))`` at each query's slot, ``pos`` being
``attn_args["q_positions"]`` as in the JAX package. The router has no
e-score bias: softmax of the float32 logits, groups ranked by the sum of
their top 2 (of ``min(2, experts a group)``), ``topk_group`` groups kept
(the others' scores set to 0), the top k of those, weighted by their softmax
scores, divided by their sum (plus 1e-20) under ``norm_topk_prob``, times
``routed_scaling_factor``, rounded to the tokens' type. The shared experts
may be absent (``n_shared_experts`` None).
"""

from __future__ import annotations

import torch

from ...ops.moe import _top_k
from ..deepseek_v3.modeling_deepseek_v3 import (
    DeepseekV3Attention,
    DeepseekV3DecoderLayer,
    DeepseekV3ForCausalLM,
    DeepseekV3MoE,
)
from ..llama.modeling_llama import LlamaModel
from .configuration_mistral4 import Mistral4Config


class Mistral4Attention(DeepseekV3Attention):
    def scale_q(self, q, attn_args):
        pos = attn_args.get("q_positions")
        beta = getattr(self.config, "llama_4_scaling_beta", None)
        if pos is None or not beta:
            return q
        omax = self.config.original_max_position_embeddings
        scale = 1.0 + beta * torch.log1p(torch.floor(pos.float() / omax))
        return q * scale[:, :, None, None].to(q.dtype)


def mistral4_route(scores: torch.Tensor, *, top_k: int, n_group: int, topk_group: int,
                   norm_topk_prob: bool, routed_scaling_factor: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Softmax group routing (JAX ``modeling_mistral4.py:35-56``) over the
    float32 scores [T, E]. Returns (weights [T, k] float32, indices [T, k])."""
    t, e = scores.shape
    grouped = scores.reshape(t, n_group, e // n_group)
    group_idx = _top_k(_top_k(grouped, min(2, e // n_group))[0].sum(-1), topk_group)[1]
    allowed = torch.zeros((t, n_group), dtype=torch.bool, device=scores.device)
    allowed.scatter_(1, group_idx, True)
    choice = scores.masked_fill(~allowed.repeat_interleave(e // n_group, dim=-1), 0.0)
    idx = _top_k(choice, top_k)[1]
    weights = scores.gather(-1, idx)
    if norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * routed_scaling_factor, idx


class Mistral4MoE(DeepseekV3MoE):
    correction_bias = False

    def route(self, x):
        cfg = self.config
        weights, idx = mistral4_route(torch.softmax(self.gate(x), dim=-1), top_k=self.top_k,
                                      n_group=cfg.n_group, topk_group=cfg.topk_group,
                                      norm_topk_prob=cfg.norm_topk_prob,
                                      routed_scaling_factor=cfg.routed_scaling_factor)
        return weights.to(x.dtype), idx


class Mistral4DecoderLayer(DeepseekV3DecoderLayer):
    attention_cls = Mistral4Attention
    moe_cls = Mistral4MoE


class Mistral4Model(LlamaModel):
    decoder_layer_cls = Mistral4DecoderLayer


class Mistral4ForCausalLM(DeepseekV3ForCausalLM):
    config_class = Mistral4Config
    model_cls = Mistral4Model
