"""Phi-3 decoder (port of transformers_tpu/models/phi3/modeling_phi3.py;
reference src/transformers/models/phi3/modeling_phi3.py).

The Llama skeleton with the checkpoint's fused projections:
``self_attn.qkv_proj`` packs [q | k | v] along the output dim (Phi3Attention)
and ``mlp.gate_up_proj`` packs [gate | up] (Phi3MLP); LongRoPE comes from the
shared rope tables. Phi-3-mini's head_dim is 96 (3072 / 32), which K1, K2 and
K6 take.
"""

from __future__ import annotations

from torch import nn

from ...core.module import Linear
from ...ops.activations import get_activation
from ..llama.modeling_llama import (
    LlamaAttention,
    LlamaDecoderLayer,
    LlamaForCausalLM,
    LlamaModel,
    LlamaModelStandalone,
)
from .configuration_phi3 import Phi3Config


class Phi3MLP(nn.Module):
    def __init__(self, config, *, dtype, param_dtype, device):
        super().__init__()
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        self.gate_up_proj = Linear(config.hidden_size, 2 * config.intermediate_size, False, **kw)
        self.down_proj = Linear(config.intermediate_size, config.hidden_size, False, **kw)
        self.act_fn = get_activation(config.hidden_act)
        self.intermediate_size = config.intermediate_size

    def forward(self, x):
        gate, up = self.gate_up_proj(x).split(self.intermediate_size, dim=-1)
        return self.down_proj(self.act_fn(gate) * up)


class Phi3Attention(LlamaAttention):
    def build_projections(self, config, qkv_bias, o_bias, kw):
        op_size = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        self.qkv_proj = Linear(config.hidden_size, op_size, qkv_bias, **kw)
        self.o_proj = Linear(self.num_heads * self.head_dim, config.hidden_size, o_bias, **kw)

    def project_qkv(self, hidden):
        """q, k and v from the one fused product, each made contiguous: the
        kernels take dense [B, S, heads, D] tensors, not views into qkv."""
        b, s, _ = hidden.shape
        kv_size = self.num_kv_heads * self.head_dim
        q, k, v = self.qkv_proj(hidden).split(
            (self.num_heads * self.head_dim, kv_size, kv_size), dim=-1)
        return (q.reshape(b, s, self.num_heads, self.head_dim).contiguous(),
                k.reshape(b, s, self.num_kv_heads, self.head_dim).contiguous(),
                v.reshape(b, s, self.num_kv_heads, self.head_dim).contiguous())


class Phi3DecoderLayer(LlamaDecoderLayer):
    attention_cls = Phi3Attention
    mlp_cls = Phi3MLP


class Phi3Model(LlamaModel):
    decoder_layer_cls = Phi3DecoderLayer


class Phi3ForCausalLM(LlamaForCausalLM):
    config_class = Phi3Config
    model_cls = Phi3Model


class Phi3ModelStandalone(LlamaModelStandalone):
    config_class = Phi3Config
    model_cls = Phi3Model
