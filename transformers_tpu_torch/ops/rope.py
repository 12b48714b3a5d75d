"""Rotary position embedding.

Port of ``transformers_tpu/ops/rope.py``: the frequency tables of every rope
type (default, linear, dynamic NTK and its HunYuan alpha variant, yarn,
longrope, llama3) are host numpy, computed once from the config; the
positional application is PyTorch, in the Llama layout (each half of the
rotated dims one member of a pair) or the interleaved one (ERNIE-4.5,
Cohere: pairs of adjacent dims).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch


def _default_inv_freq(config, head_dim: Optional[int] = None) -> np.ndarray:
    base = getattr(config, "rope_theta", 10000.0)
    if head_dim is None:
        head_dim = getattr(config, "head_dim", None) or config.hidden_size // config.num_attention_heads
    partial = getattr(config, "partial_rotary_factor", 1.0)
    dim = int(head_dim * partial)
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))


def _rope_params_default(config, **kwargs):
    return _default_inv_freq(config), 1.0


def _rope_params_linear(config, **kwargs):
    factor = config.rope_scaling["factor"]
    return _default_inv_freq(config) / factor, 1.0


def _rope_params_dynamic(config, seq_len: Optional[int] = None, **kwargs):
    """Dynamic NTK (reference modeling_rope_utils.py:269). Uses max training len.
    With an ``alpha`` (HunYuan: ``{"type": "dynamic", "alpha": a}``), the base
    is ``rope_theta * a ** (d / (d - 2))`` over the whole head dim and the
    scaling 1.0 (JAX ``models/hunyuan_v1_dense/modeling_hunyuan_v1_dense.py:44-57``)."""
    scaling = config.rope_scaling
    if scaling.get("alpha"):
        return _rope_params_dynamic_alpha(config)
    factor = scaling["factor"]
    base = getattr(config, "rope_theta", 10000.0)
    head_dim = getattr(config, "head_dim", None) or config.hidden_size // config.num_attention_heads
    partial = getattr(config, "partial_rotary_factor", 1.0)
    dim = int(head_dim * partial)
    max_pos = scaling.get("original_max_position_embeddings", config.max_position_embeddings)
    seq_len = max(seq_len or 0, max_pos)
    base = base * ((factor * seq_len / max_pos) - (factor - 1)) ** (dim / (dim - 2))
    inv_freq = 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    return inv_freq, 1.0


def _rope_params_dynamic_alpha(config):
    dim = getattr(config, "head_dim", None) or config.hidden_size // config.num_attention_heads
    alpha = config.rope_scaling["alpha"]
    base = getattr(config, "rope_theta", 10000.0) * alpha ** (dim / (dim - 2))
    return 1.0 / (base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)), 1.0


def _rope_params_yarn(config, **kwargs):
    """YaRN (reference modeling_rope_utils.py:345)."""
    scaling = config.rope_scaling
    base = getattr(config, "rope_theta", 10000.0)
    head_dim = getattr(config, "head_dim", None) or config.hidden_size // config.num_attention_heads
    partial = getattr(config, "partial_rotary_factor", 1.0)
    dim = int(head_dim * partial)
    factor = scaling["factor"]
    original_max = scaling.get("original_max_position_embeddings", config.max_position_embeddings)
    attention_factor = scaling.get("attention_factor")
    mscale = scaling.get("mscale")
    mscale_all_dim = scaling.get("mscale_all_dim")
    beta_fast = scaling.get("beta_fast", 32)
    beta_slow = scaling.get("beta_slow", 1)

    def get_mscale(scale, m=1.0):
        if scale <= 1:
            return 1.0
        return 0.1 * m * math.log(scale) + 1.0

    if attention_factor is None:
        if mscale and mscale_all_dim:
            attention_factor = float(get_mscale(factor, mscale) / get_mscale(factor, mscale_all_dim))
        else:
            attention_factor = get_mscale(factor)

    def find_correction_dim(num_rotations, dim, base, max_pos):
        return (dim * math.log(max_pos / (num_rotations * 2 * math.pi))) / (2 * math.log(base))

    # truncate=False (GPT-OSS) keeps fractional correction bounds
    # (reference modeling_rope_utils.py:451)
    truncate = scaling.get("truncate", True)

    def find_correction_range(low_rot, high_rot, dim, base, max_pos):
        low = find_correction_dim(low_rot, dim, base, max_pos)
        high = find_correction_dim(high_rot, dim, base, max_pos)
        if truncate:
            low = math.floor(low)
            high = math.ceil(high)
        return max(low, 0), min(high, dim - 1)

    def linear_ramp_factor(mn, mx, dim):
        if mn == mx:
            mx += 0.001
        linear_func = (np.arange(dim, dtype=np.float64) - mn) / (mx - mn)
        return np.clip(linear_func, 0, 1)

    pos_freqs = base ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    inv_freq_extrapolation = 1.0 / pos_freqs
    inv_freq_interpolation = 1.0 / (factor * pos_freqs)
    low, high = find_correction_range(beta_fast, beta_slow, dim, base, original_max)
    inv_freq_extrapolation_factor = 1 - linear_ramp_factor(low, high, dim // 2)
    inv_freq = (
        inv_freq_interpolation * (1 - inv_freq_extrapolation_factor)
        + inv_freq_extrapolation * inv_freq_extrapolation_factor
    )
    return inv_freq, attention_factor


def _rope_params_longrope(config, seq_len: Optional[int] = None, **kwargs):
    """LongRoPE (Phi-3 family; reference modeling_rope_utils.py:486)."""
    scaling = config.rope_scaling
    base = getattr(config, "rope_theta", 10000.0)
    head_dim = getattr(config, "head_dim", None) or config.hidden_size // config.num_attention_heads
    partial = getattr(config, "partial_rotary_factor", 1.0)
    dim = int(head_dim * partial)
    long_factor = scaling["long_factor"]
    short_factor = scaling["short_factor"]
    original_max = getattr(config, "original_max_position_embeddings", None) or scaling.get(
        "original_max_position_embeddings", config.max_position_embeddings
    )
    factor = config.max_position_embeddings / original_max
    attention_factor = scaling.get("attention_factor")
    if attention_factor is None:
        if factor <= 1.0:
            attention_factor = 1.0
        else:
            attention_factor = math.sqrt(1 + math.log(factor) / math.log(original_max))
    if seq_len and seq_len > original_max:
        ext_factors = np.array(long_factor, dtype=np.float64)
    else:
        ext_factors = np.array(short_factor, dtype=np.float64)
    inv_freq_shape = np.arange(0, dim, 2, dtype=np.float64) / dim
    inv_freq = 1.0 / (ext_factors * base**inv_freq_shape)
    return inv_freq, attention_factor


def _rope_params_llama3(config, **kwargs):
    """Llama-3.1 frequency-banded scaling (reference modeling_rope_utils.py:580)."""
    scaling = config.rope_scaling
    inv_freq = _default_inv_freq(config)
    factor = scaling["factor"]
    low_freq_factor = scaling["low_freq_factor"]
    high_freq_factor = scaling["high_freq_factor"]
    old_context_len = scaling["original_max_position_embeddings"]

    low_freq_wavelen = old_context_len / low_freq_factor
    high_freq_wavelen = old_context_len / high_freq_factor

    wavelen = 2 * math.pi / inv_freq
    inv_freq_llama = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth_factor = (old_context_len / wavelen - low_freq_factor) / (high_freq_factor - low_freq_factor)
    smoothed_inv_freq = (1 - smooth_factor) / factor * inv_freq + smooth_factor * inv_freq
    is_medium_freq = ~(wavelen < high_freq_wavelen) * ~(wavelen > low_freq_wavelen)
    inv_freq_llama = np.where(is_medium_freq, smoothed_inv_freq, inv_freq_llama)
    return inv_freq_llama, 1.0


ROPE_INIT_FUNCTIONS = {
    "default": _rope_params_default,
    "linear": _rope_params_linear,
    "dynamic": _rope_params_dynamic,
    "yarn": _rope_params_yarn,
    "longrope": _rope_params_longrope,
    "llama3": _rope_params_llama3,
}


def rope_inv_freq(config, seq_len: Optional[int] = None) -> tuple[np.ndarray, float]:
    """Resolve (inv_freq [dim/2] float64, attention_scaling) from config."""
    scaling = getattr(config, "rope_scaling", None)
    if scaling is None:
        rope_type = "default"
    else:
        rope_type = scaling.get("rope_type", scaling.get("type", "default"))
    return ROPE_INIT_FUNCTIONS[rope_type](config, seq_len=seq_len)


def compute_cos_sin(position_ids: torch.Tensor, inv_freq: np.ndarray,
                    attention_scaling: float = 1.0,
                    dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [B, S, dim] from integer positions (float32 internally)."""
    inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=position_ids.device)
    freqs = position_ids.float()[..., None] * inv[None, None, :]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = torch.cos(emb) * attention_scaling
    sin = torch.sin(emb) * attention_scaling
    return cos.to(dtype), sin.to(dtype)


def compute_cos_sin_interleaved(position_ids: torch.Tensor, inv_freq: np.ndarray,
                                attention_scaling: float = 1.0,
                                dtype: torch.dtype = torch.float32
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Interleaved-layout cos/sin tables [B, S, dim]: each frequency repeated
    twice in place (reference models/cohere/modeling_cohere.py:115), not the
    Llama layout's two concatenated halves."""
    inv = torch.as_tensor(inv_freq, dtype=torch.float32, device=position_ids.device)
    freqs = position_ids.float()[..., None] * inv[None, None, :]
    emb = torch.repeat_interleave(freqs, 2, dim=-1)
    cos = torch.cos(emb) * attention_scaling
    sin = torch.sin(emb) * attention_scaling
    return cos.to(dtype), sin.to(dtype)


def rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """Pairwise rotation (x0, x1) -> (-x1, x0) (reference cohere ``rotate_half``)."""
    return torch.stack([-x[..., 1::2], x[..., ::2]], dim=-1).reshape(x.shape)


def apply_rotary_pos_emb_interleaved(q, k, cos, sin):
    """Interleaved rotary in BSHD layout, in float32 (the reference upcasts q/k
    before rotating, cohere modeling_cohere.py:183), each result cast back to
    its input's dtype. Partial rotary: D_rot < D rotates the leading slice."""
    d_rot = cos.shape[-1]
    cos = cos[:, :, None, :].float()
    sin = sin[:, :, None, :].float()

    def rot(x):
        h = x.float()
        if d_rot == x.shape[-1]:
            out = (h * cos) + (rotate_half_interleaved(h) * sin)
        else:
            h_rot = h[..., :d_rot]
            h_rot = (h_rot * cos) + (rotate_half_interleaved(h_rot) * sin)
            out = torch.cat([h_rot, h[..., d_rot:]], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(reference models/llama/modeling_llama.py:126)"""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rotary_pos_emb(q, k, cos, sin):
    """Apply rotary embedding to q/k in BSHD layout, in their dtype.

    q: [B, S, H, D], k: [B, S, KVH, D], cos/sin: [B, S, D_rot].
    Partial rotary: D_rot < D rotates the leading slice only.
    """
    d_rot = cos.shape[-1]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]

    def rot(x):
        if d_rot == x.shape[-1]:
            return (x * cos) + (rotate_half(x) * sin)
        x_rot, x_pass = x[..., :d_rot], x[..., d_rot:]
        x_rot = (x_rot * cos) + (rotate_half(x_rot) * sin)
        return torch.cat([x_rot, x_pass], dim=-1)

    return rot(q), rot(k)
