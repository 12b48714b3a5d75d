"""Phi-3.5-MoE decoder (port of transformers_tpu/models/phimoe/modeling_phimoe.py;
reference src/transformers/models/phimoe/modeling_phimoe.py).

Mixtral's checkpoint layout (``block_sparse_moe``: router ``gate``, experts
``w1`` / ``w3`` / ``w2``) over the stacked experts of ``ops/moe.py``, routed
by the sparsemixer's top-2 (eval path); biased LayerNorms in the layers and
the final norm; an ``lm_head`` bias when ``lm_head_bias``; LongRoPE from the
shared rope tables.
"""

from __future__ import annotations

import torch

from ...core.module import LayerNorm, Linear
from ...ops.moe import SparseMoeBlock
from ..llama.modeling_llama import (
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_phimoe import PhimoeConfig


def sparsemixer_route(logits: torch.Tensor, jitter_eps: float
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sparsemixer's eval path (JAX ``sparsemixer_route``): each pick is
    the argmax of the scores (the first index among ties, as ``jnp.argmax``)
    and weighs the softmax, at that index, of the scores with every candidate
    dropped whose gap to the maximum, ``(max - raw) / max(|raw|, max)``,
    exceeds ``2·jitter_eps``; the second pick runs on the scores with the
    first set to -inf, the gaps still measured on the raw logits. Returns
    (weights [T, 2] float32, indices [T, 2] int64)."""
    raw = logits.float()

    def pick(scores):
        m = scores.max(dim=-1, keepdim=True).values
        factor = torch.maximum(raw.abs(), m)
        gates = scores.masked_fill((m - raw) / factor > 2 * jitter_eps, float("-inf"))
        sel = scores.argmax(dim=-1, keepdim=True)
        return torch.softmax(gates, dim=-1).gather(-1, sel)[:, 0], sel[:, 0]

    w1, s1 = pick(raw)
    w2, s2 = pick(raw.scatter(-1, s1[:, None], float("-inf")))
    return torch.stack([w1, w2], dim=-1), torch.stack([s1, s2], dim=-1)


class PhimoeSparseMoeBlock(SparseMoeBlock):
    def __init__(self, config: PhimoeConfig, *, dtype, param_dtype, device):
        super().__init__(config, config.num_local_experts, config.intermediate_size, False,
                         names=("w1", "w3", "w2"), dtype=dtype, param_dtype=param_dtype,
                         device=device)

    def route(self, x):
        return sparsemixer_route(self.gate(x), self.config.router_jitter_noise)


class PhimoeDecoderLayer(LlamaDecoderLayer):
    mlp_cls = PhimoeSparseMoeBlock
    mlp_name = "block_sparse_moe"

    @staticmethod
    def make_norm(config, **kw):
        return LayerNorm(config.hidden_size, config.rms_norm_eps, **kw)


class PhimoeModel(LlamaModel):
    decoder_layer_cls = PhimoeDecoderLayer


class PhimoeForCausalLM(LlamaForCausalLM):
    config_class = PhimoeConfig
    model_cls = PhimoeModel

    def __init__(self, config: PhimoeConfig, *, dtype=torch.float32, param_dtype=None,
                 device="cuda"):
        super().__init__(config, dtype=dtype, param_dtype=param_dtype, device=device)
        if not config.tie_word_embeddings and config.lm_head_bias:
            self.lm_head = Linear(config.hidden_size, config.vocab_size, True, dtype=self.dtype,
                                  param_dtype=self.param_dtype, device=self.device,
                                  init_std=config.initializer_range)


class PhimoeModelStandalone(LlamaModelStandalone):
    config_class = PhimoeConfig
    model_cls = PhimoeModel
