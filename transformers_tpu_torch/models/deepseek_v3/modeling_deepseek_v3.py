"""DeepSeek-V3 decoder (port of transformers_tpu/models/deepseek_v3/modeling_deepseek_v3.py;
reference src/transformers/models/deepseek_v3/modeling_deepseek_v3.py).

- **Multi-head latent attention (MLA).** The queries come through
  ``q_proj`` or the low-rank ``q_a_proj`` -> ``q_a_layernorm`` ->
  ``q_b_proj``; ``kv_a_proj_with_mqa`` gives the key/value latent (through
  ``kv_a_layernorm``) and one rope key shared by every head. The rope turns
  only the rotary slice (``apply_mla_rope``). The cache holds the latents, not
  per-head keys and values: in the bhsd layout the "keys" are the latent
  ``[B, 1, S, kv_lora_rank]`` and the "values" the rotated shared key ``[B, 1,
  S, qk_rope_head_dim]`` (``DeepseekV3ForCausalLM.init_cache``). Each step writes its latents and
  re-expands the whole cached history through ``kv_b_proj`` (``expand_kv``),
  as the JAX package does, then attends through the registry; with values
  narrower than queries and keys (192 against 128 at the published widths)
  that is the eager attention, as in JAX. A static prefill expands its own
  latents only; the cache holds nothing else yet. A paged cache is refused:
  the continuous-batching engine does not take MLA models (neither does the
  JAX package's).
- **Router** (``deepseek_route``): sigmoid scores in float32, the
  ``e_score_correction_bias`` added for the choice only; groups ranked by the
  sum of their top 2, ``topk_group`` of them kept, the top k taken among
  their experts; the weights are the unbiased scores, divided by their sum
  (plus 1e-20) under ``norm_topk_prob``, times ``routed_scaling_factor``.
  Every top-k is the stable ``_top_k`` of ``ops/moe.py``, so ties go to the
  lower index as in ``jax.lax.top_k``.
- **MoE block** (``DeepseekV3MoE``): the routed experts, stacked
  (``ops/moe.py`` ``Experts``, both expert routes), plus the shared experts,
  one gated MLP of ``moe_intermediate_size x n_shared_experts``. The gate
  keeps the hub's ``[E, H]`` weight (the JAX package keeps ``[H, E]``) and
  the float32 ``e_score_correction_bias``. Layers below
  ``first_k_dense_replace`` have a dense MLP.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...cache_utils import StaticKVCache
from ...core.module import Linear, RMSNorm
from ...ops.attention import get_attention_fn
from ...ops.moe import SparseMoeBlock, _top_k
from ...ops.rope import apply_rope_interleave_deepseek, apply_rotary_pos_emb, yarn_mscale_factor
from ..llama.modeling_llama import LlamaDecoderLayer, LlamaForCausalLM, LlamaMLP, LlamaModel
from .configuration_deepseek_v3 import DeepseekV3Config


class DeepseekV3Attention(nn.Module):
    """MLA (JAX ``modeling_deepseek_v3.py:77-176``)."""

    def __init__(self, config, layer_idx: int, *, dtype, param_dtype, device):
        super().__init__()
        self.config = config
        self.layer_idx = layer_idx
        self.dtype = dtype
        self.num_heads = config.num_attention_heads
        self.q_lora_rank = config.q_lora_rank
        self.kv_lora_rank = config.kv_lora_rank
        self.qk_rope_head_dim = config.qk_rope_head_dim
        self.qk_nope_head_dim = config.qk_nope_head_dim
        self.v_head_dim = config.v_head_dim
        self.qk_head_dim = config.qk_nope_head_dim + config.qk_rope_head_dim
        self.scale = self.qk_head_dim ** -0.5 * yarn_mscale_factor(config)
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device,
                  init_std=config.initializer_range)
        norm_kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        bias = config.attention_bias
        h = config.hidden_size
        if self.q_lora_rank is None:
            self.q_proj = Linear(h, self.num_heads * self.qk_head_dim, False, **kw)
        else:
            self.q_a_proj = Linear(h, self.q_lora_rank, bias, **kw)
            self.q_a_layernorm = RMSNorm(self.q_lora_rank, config.rms_norm_eps, **norm_kw)
            self.q_b_proj = Linear(self.q_lora_rank, self.num_heads * self.qk_head_dim, False,
                                   **kw)
        self.kv_a_proj_with_mqa = Linear(h, self.kv_lora_rank + self.qk_rope_head_dim, bias, **kw)
        self.kv_a_layernorm = RMSNorm(self.kv_lora_rank, config.rms_norm_eps, **norm_kw)
        self.kv_b_proj = Linear(self.kv_lora_rank,
                                self.num_heads * (self.qk_nope_head_dim + self.v_head_dim), False,
                                **kw)
        self.o_proj = Linear(self.num_heads * self.v_head_dim, h, bias, **kw)

    def apply_mla_rope(self, q_rot, k_rot, cos, sin):
        """The rope on q's rotary slice [B, S, H, Dr] and the shared key [B, S,
        Dr]; DeepSeek-V2 overrides it with its complex pairs."""
        if self.config.rope_interleave:
            return (apply_rope_interleave_deepseek(q_rot, cos, sin),
                    apply_rope_interleave_deepseek(k_rot[:, :, None], cos, sin)[:, :, 0])
        q_rot, k_rot = apply_rotary_pos_emb(q_rot, k_rot[:, :, None], cos, sin)
        return q_rot, k_rot[:, :, 0]

    def scale_q(self, q, attn_args):
        """Hook: scaling of the rotated queries (Mistral4's attention temperature)."""
        return q

    def expand_kv(self, latent, k_rot):
        """Latents [B, S, R] and the shared rope key [B, S, Dr] -> per-head keys
        [B, S, H, Dk] and values [B, S, H, Dv] (JAX ``expand_kv``, :129-139),
        both contiguous, as the flash kernel takes them."""
        b, s, _ = latent.shape
        kv = self.kv_b_proj(latent).reshape(b, s, self.num_heads,
                                            self.qk_nope_head_dim + self.v_head_dim)
        k_nope, v = kv.split([self.qk_nope_head_dim, self.v_head_dim], dim=-1)
        k_rot = k_rot[:, :, None].to(k_nope.dtype).expand(b, s, self.num_heads,
                                                          self.qk_rope_head_dim)
        return torch.cat([k_nope, k_rot], dim=-1), v.contiguous()

    def forward(self, hidden, cos, sin, attn_args, cache, cache_position):
        b, s, _ = hidden.shape
        if self.q_lora_rank is None:
            q = self.q_proj(hidden)
        else:
            q = self.q_b_proj(self.q_a_layernorm(self.q_a_proj(hidden)))
        q = q.reshape(b, s, self.num_heads, self.qk_head_dim)
        q_pass, q_rot = q.split([self.qk_nope_head_dim, self.qk_rope_head_dim], dim=-1)
        compressed = self.kv_a_proj_with_mqa(hidden)
        latent, k_rot = compressed.split([self.kv_lora_rank, self.qk_rope_head_dim], dim=-1)
        latent = self.kv_a_layernorm(latent)
        q_rot, k_rot = self.apply_mla_rope(q_rot, k_rot, cos, sin)
        q = self.scale_q(torch.cat([q_pass, q_rot], dim=-1), attn_args)

        kwargs = dict(attn_args)
        is_static_prefill = isinstance(cache_position, int) and cache_position == 0 and s > 1
        if cache is not None:
            if getattr(cache, "layout", None) == "paged":
                raise NotImplementedError("multi-head latent attention over a paged cache: "
                                          "continuous batching does not take MLA models")
            cache.update(self.layer_idx, latent[:, :, None], k_rot[:, :, None], cache_position)
            if is_static_prefill:
                if kwargs.get("kv_valid") is not None:
                    kwargs["kv_valid"] = kwargs["kv_valid"][:, :s]
            else:
                latents, rope_keys = cache.layer(self.layer_idx)
                latent, k_rot = latents[:, 0].to(self.dtype), rope_keys[:, 0].to(self.dtype)
        k, v = self.expand_kv(latent, k_rot)
        out = get_attention_fn(self.config.attn_implementation)(q, k, v, scale=self.scale,
                                                                **kwargs)
        return self.o_proj(out.reshape(b, s, self.num_heads * self.v_head_dim))


def deepseek_route(scores: torch.Tensor, bias: torch.Tensor, *, n_group: int, topk_group: int,
                   top_k: int, norm_topk_prob: bool, routed_scaling_factor: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sigmoid group-limited routing (JAX ``modeling_deepseek_v3.py:188-207``)
    over the float32 scores [T, E], the bias added for the choice only.
    Returns (weights [T, k] float32, indices [T, k])."""
    t, e = scores.shape
    choice = scores + bias[None, :]
    group_rank = _top_k(choice.reshape(t, n_group, e // n_group), 2)[0].sum(-1)  # [T, G]
    group_idx = _top_k(group_rank, topk_group)[1]
    allowed = torch.zeros((t, n_group), dtype=torch.bool, device=scores.device)
    allowed.scatter_(1, group_idx, True)
    allowed = allowed.repeat_interleave(e // n_group, dim=-1)
    idx = _top_k(choice.masked_fill(~allowed, float("-inf")), top_k)[1]
    weights = scores.gather(-1, idx)
    if norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return weights * routed_scaling_factor, idx


class DeepseekV3TopkRouter(nn.Module):
    """The gate: ``weight`` [E, H] in the hub's layout and, where the family
    has one, the float32 ``e_score_correction_bias`` [E]. Its logits are
    computed in float32 whatever the model's type."""

    def __init__(self, config, *, param_dtype, device, correction_bias: bool = True):
        super().__init__()
        self.init_std = config.initializer_range
        self.weight = nn.Parameter(torch.empty((config.n_routed_experts, config.hidden_size),
                                               dtype=param_dtype, device=device))
        self.e_score_correction_bias = None
        if correction_bias:
            self.e_score_correction_bias = nn.Parameter(
                torch.empty((config.n_routed_experts,), dtype=torch.float32, device=device),
                requires_grad=False)

    @torch.no_grad()
    def init_parameter(self, name: str, generator: torch.Generator) -> None:
        if name == "weight":
            self.weight.normal_(0.0, self.init_std, generator=generator)
        else:
            self.e_score_correction_bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.float(), self.weight.float())


class DeepseekV3MoE(SparseMoeBlock):
    """Routed experts plus shared experts (JAX ``modeling_deepseek_v3.py:210-251``)."""

    correction_bias = True  # whether the gate has an e-score bias (Mistral4's has none)
    float32_gate = False  # whether the gate's weight is kept in float32 (DeepSeek-V2's is)

    def __init__(self, config, *, dtype, param_dtype, device):
        kw = dict(dtype=dtype, param_dtype=param_dtype, device=device)
        super().__init__(config, config.n_routed_experts, config.moe_intermediate_size,
                         config.norm_topk_prob, **kw)
        self.gate = DeepseekV3TopkRouter(
            config, param_dtype=torch.float32 if self.float32_gate else param_dtype,
            device=device, correction_bias=self.correction_bias)
        self.shared_experts = None
        if config.n_shared_experts:
            self.shared_experts = LlamaMLP(
                config, intermediate_size=config.moe_intermediate_size * config.n_shared_experts,
                **kw)

    def route(self, x):
        cfg = self.config
        return deepseek_route(torch.sigmoid(self.gate(x)), self.gate.e_score_correction_bias,
                              n_group=cfg.n_group, topk_group=cfg.topk_group, top_k=self.top_k,
                              norm_topk_prob=cfg.norm_topk_prob,
                              routed_scaling_factor=cfg.routed_scaling_factor)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        b, s, h = hidden.shape
        x = hidden.reshape(b * s, h)
        out = self.routed(x)
        if self.shared_experts is not None:
            out = out + self.shared_experts(x)
        return out.reshape(b, s, h).to(hidden.dtype)


class DeepseekV3DecoderLayer(LlamaDecoderLayer):
    attention_cls = DeepseekV3Attention
    moe_cls = DeepseekV3MoE

    def make_mlp(self, config, layer_idx: int, **kw):
        if layer_idx >= config.first_k_dense_replace:
            return self.moe_cls(config, **kw)
        return LlamaMLP(config, **kw)


class DeepseekV3Model(LlamaModel):
    decoder_layer_cls = DeepseekV3DecoderLayer


class DeepseekV3ForCausalLM(LlamaForCausalLM):
    config_class = DeepseekV3Config
    model_cls = DeepseekV3Model
    # the continuous-batching engine's pools hold per-head keys and values
    paged_kv_cache = False

    def init_cache(self, batch_size: int, max_len: int, dtype=None,
                   implementation: str = "static") -> StaticKVCache:
        """The MLA cache (JAX ``modeling_deepseek_v3.py:309-323``): per layer,
        the latents ``[B, 1, max_len, kv_lora_rank]`` as the keys and the
        rotated shared rope key ``[B, 1, max_len, qk_rope_head_dim]`` as the
        values. The JAX package builds it whatever ``implementation`` says;
        the port refuses ``"quantized"``: an int8 cache of latents is no
        feature of either."""
        if implementation == "quantized":
            raise ValueError("the multi-head latent attention cache holds latents: "
                             "cache_implementation='quantized' is not supported for it")
        cfg = self.config

        def buffers(width):
            return [torch.zeros((batch_size, 1, max_len, width), dtype=dtype or self.dtype,
                                device=self.device) for _ in range(cfg.num_hidden_layers)]

        return StaticKVCache(buffers(cfg.kv_lora_rank), buffers(cfg.qk_rope_head_dim),
                             (None,) * cfg.num_hidden_layers, max_len)
