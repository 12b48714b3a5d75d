"""The PyTorch port's ops against the JAX package's, on the CPU.

- The flash kernel's wrapper (here: its plain PyTorch version) against JAX
  ``flash_attention``, whose Pallas kernel runs in interpret mode on the CPU,
  on the cases of tests/ops/test_flash_attention.py.
- The fused decode wrapper (plain version) against JAX
  ``fused_decode_attention(..., interpret=True)`` on the cases of
  tests/ops/test_fused_decode.py, updated caches included.
- rope, RMSNorm, activations, masks, ``eager_attention`` and
  ``cached_attention_bhsd`` against their JAX counterparts.

Inputs are made from a seed with numpy. Tolerances: 2e-5 in float32 (sums in
another order); 2e-2 in bf16, one rounding step of bf16 at the outputs'
magnitude (the Pallas kernels also round probabilities to bf16 before P.V,
the port keeps them in f32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformers_tpu.core.module import RMSNorm as JaxRMSNorm
from transformers_tpu.ops import activations as jax_act
from transformers_tpu.ops import attention as jax_attn
from transformers_tpu.ops import masks as jax_masks
from transformers_tpu.ops import rope as jax_rope
from transformers_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from transformers_tpu.ops.pallas.fused_decode import fused_decode_attention as jax_fused_decode
from transformers_tpu_torch.core.module import RMSNorm
from transformers_tpu_torch.ops import activations, attention, masks, rope
from transformers_tpu_torch.ops.flash_attention import flash_attention
from transformers_tpu_torch.ops.fused_decode import fused_decode_attention

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _pair(x, dtype):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    t = torch.as_tensor(np.asarray(x, np.float32)).to(dtype)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16
                                                 else jnp.float32), t


def _assert_close(port_out, jax_out, tol):
    a = port_out.float().numpy()
    b = np.asarray(jax_out, np.float32)
    np.testing.assert_allclose(a, b, atol=tol, rtol=tol)


# ------------------------------------------------------------- flash (K1)
FLASH_CASES = {
    # name: (b, sq, skv, h, kvh, d, dtype, left pads per row, window, cap)
    "causal_128_128": (2, 128, 128, 4, 2, 64, torch.float32, None, None, None),
    "causal_64_256": (2, 64, 256, 4, 2, 64, torch.float32, None, None, None),
    "causal_100_300": (2, 100, 300, 4, 2, 64, torch.float32, None, None, None),
    "padded_kv": (2, 64, 192, 4, 4, 64, torch.float32, (40, 10), None, None),
    "sliding_window": (1, 256, 256, 2, 2, 64, torch.float32, None, 64, None),
    "logit_cap": (1, 128, 128, 2, 2, 64, torch.float32, None, None, 30.0),
    "bf16_gqa": (2, 128, 128, 4, 2, 128, torch.bfloat16, None, None, None),
}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_plain_matches_jax_pallas(case):
    b, sq, skv, h, kvh, d, dtype, pads, window, cap = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    jq, q = _pair(rng.standard_normal((b, sq, h, d)), dtype)
    jk, k = _pair(rng.standard_normal((b, skv, kvh, d)), dtype)
    jv, v = _pair(rng.standard_normal((b, skv, kvh, d)), dtype)
    # queries occupy the last sq slots of the kv timeline
    qpos = np.broadcast_to(skv - sq + np.arange(sq, dtype=np.int32)[None], (b, sq)).copy()
    valid = np.ones((b, skv), np.int32)
    for row, p in enumerate(pads or ()):
        valid[row, :p] = 0
    ref = jax_flash(jq, jk, jv, q_positions=jnp.asarray(qpos), kv_valid=jnp.asarray(valid),
                    sliding_window=window, logit_cap=cap)
    before = flash_attention.launches
    out = flash_attention(q, k, v, q_positions=torch.as_tensor(qpos),
                          kv_valid=torch.as_tensor(valid), sliding_window=window, logit_cap=cap)
    assert flash_attention.launches == before  # CPU tensors never reach the kernel
    assert out.dtype == dtype and out.shape == (b, sq, h, d)
    _assert_close(out, ref, F32_TOL if dtype == torch.float32 else BF16_TOL)


def test_flash_plain_fully_masked_rows_are_zero():
    """A query row that sees no slot gives 0 and lse -inf (left-pad rows)."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.as_tensor(rng.standard_normal((1, 8, 2, 64)), dtype=torch.float32)
               for _ in range(3))
    valid = torch.tensor([[0, 0, 0, 1, 1, 1, 1, 1]], dtype=torch.int32)
    out, lse = flash_attention(q, k, v, kv_valid=valid, return_lse=True)
    assert torch.all(out[0, :3] == 0) and torch.all(torch.isneginf(lse[0, :, :3]))
    assert torch.all(torch.isfinite(lse[0, :, 3:]))


# ------------------------------------------------------ fused decode (K2)
DECODE_CASES = {
    # name: (b, h, kvh, d, s, pos, dtype, starts, holes)
    "gqa_1": (3, 4, 4, 128, 64, 41, torch.float32, None, ()),
    "gqa_4": (3, 8, 2, 128, 64, 41, torch.float32, None, ()),
    "gqa_8": (3, 16, 2, 128, 64, 41, torch.float32, None, ()),
    "first_token": (2, 8, 4, 128, 64, 0, torch.float32, None, ()),
    "left_padding_starts": (3, 8, 2, 128, 64, 50, torch.float32, (0, 7, 23), ()),
    "mask_holes": (2, 4, 4, 128, 64, 30, torch.float32, None, ((0, 5), (1, 12), (1, 13))),
    "bf16": (4, 8, 2, 128, 128, 100, torch.bfloat16, None, ()),
    "chunked_long_context": (4, 8, 8, 128, 1536, 1200, torch.bfloat16, (0, 100, 511, 512), ()),
    "bench_geometry": (8, 32, 8, 128, 224, 192, torch.bfloat16, None, ()),
}


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_fused_decode_plain_matches_jax_pallas(case):
    b, h, kvh, d, s, pos, dtype, starts, holes = DECODE_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    jq, q = _pair(rng.standard_normal((b, 1, h, d)), dtype)
    jkn, kn = _pair(rng.standard_normal((b, 1, kvh, d)), dtype)
    jvn, vn = _pair(rng.standard_normal((b, 1, kvh, d)), dtype)
    ang = rng.standard_normal((b, 1, d))
    jcos, cos = _pair(np.cos(ang), dtype)
    jsin, sin = _pair(np.sin(ang), dtype)
    jkc, kc = _pair(rng.standard_normal((b, kvh, s, d)), dtype)
    jvc, vc = _pair(rng.standard_normal((b, kvh, s, d)), dtype)
    start = np.zeros((b,), np.int32) if starts is None else np.asarray(starts, np.int32)
    valid = np.ones((b, s), np.int32)
    for bi, si in holes:
        valid[bi, si] = 0
    scale = d ** -0.5
    ref, ref_kc, ref_vc = jax_fused_decode(
        jq, jkn, jvn, jcos, jsin, jkc, jvc, jnp.asarray(pos, jnp.int32), jnp.asarray(start),
        jnp.asarray(valid), scale=scale, interpret=True)
    before = fused_decode_attention.launches
    out = fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos, torch.as_tensor(start),
                                 torch.as_tensor(valid), scale=scale)
    assert fused_decode_attention.launches == before
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _assert_close(out, ref, tol)
    _assert_close(kc, ref_kc, tol)  # caches updated in place at slot pos
    _assert_close(vc, ref_vc, tol)


# ------------------------------------------------------------------ rope
ROPE_SCALINGS = {
    "default": None,
    "linear": {"rope_type": "linear", "factor": 2.0},
    "dynamic": {"rope_type": "dynamic", "factor": 2.0},
    "yarn": {"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": 32},
    "longrope": {"rope_type": "longrope", "long_factor": [1.5] * 32, "short_factor": [1.1] * 32,
                 "original_max_position_embeddings": 32},
    "llama3": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
               "high_freq_factor": 4.0, "original_max_position_embeddings": 32},
}


class _Cfg:
    hidden_size = 256
    num_attention_heads = 4
    head_dim = 64
    rope_theta = 10000.0
    max_position_embeddings = 128

    def __init__(self, rope_scaling):
        self.rope_scaling = rope_scaling


@pytest.mark.parametrize("kind", list(ROPE_SCALINGS))
def test_rope_tables_and_application_match_jax(kind):
    cfg = _Cfg(ROPE_SCALINGS[kind])
    inv, scaling = rope.rope_inv_freq(cfg, seq_len=100)
    jinv, jscaling = jax_rope.rope_inv_freq(cfg, seq_len=100)
    np.testing.assert_array_equal(inv, jinv)
    assert scaling == jscaling
    rng = np.random.default_rng(1)
    pos = np.array([[0, 0, 1, 2, 3, 4, 5, 90], [7, 8, 9, 10, 11, 12, 13, 14]], np.int32)
    cos, sin = rope.compute_cos_sin(torch.as_tensor(pos), inv, scaling)
    jcos, jsin = jax_rope.compute_cos_sin(jnp.asarray(pos), jinv, jscaling)
    _assert_close(cos, jcos, F32_TOL)
    _assert_close(sin, jsin, F32_TOL)
    q = rng.standard_normal((2, 8, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 8, 2, 64)).astype(np.float32)
    rq, rk = rope.apply_rotary_pos_emb(torch.as_tensor(q), torch.as_tensor(k), cos, sin)
    jq, jk = jax_rope.apply_rotary_pos_emb(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    _assert_close(rq, jq, F32_TOL)
    _assert_close(rk, jk, F32_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rmsnorm_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 96)).astype(np.float32) * 3
    w = 1 + 0.1 * rng.standard_normal(96).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    norm = RMSNorm(96, 1e-6, dtype=dtype, device="cpu")
    with torch.no_grad():
        norm.weight.copy_(torch.as_tensor(w))
        out = norm(torch.as_tensor(x).to(dtype))
    ref = JaxRMSNorm(96, 1e-6, dtype=jdt)({"weight": jnp.asarray(w)}, jnp.asarray(x).astype(jdt))
    _assert_close(out, ref, F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("name", sorted(activations.ACT2FN))
def test_activation_matches_jax(name):
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    out = activations.get_activation(name)(torch.as_tensor(x))
    ref = jax_act.get_activation(name)(jnp.asarray(x))
    _assert_close(out, ref, 1e-5)


def test_segment_ids_from_position_ids_match_jax():
    pos = np.array([[0, 1, 2, 0, 1, 0, 1, 2, 3], [0, 1, 2, 3, 4, 5, 6, 7, 8]], np.int32)
    out = masks.segment_ids_from_position_ids(torch.as_tensor(pos))
    ref = jax_masks.segment_ids_from_position_ids(jnp.asarray(pos))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


# ----------------------------------------------------- eager attention paths
EAGER_CASES = {
    "causal_padded": dict(),
    "window": dict(sliding_window=3),
    "softcap": dict(logit_cap=5.0),
    "segments": dict(segments=True),
    "bidirectional_window": dict(is_causal=False, sliding_window=2),
}


@pytest.mark.parametrize("case", list(EAGER_CASES))
def test_eager_attention_matches_jax(case):
    kw = dict(EAGER_CASES[case])
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 6, 2, 16)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    valid = np.array([[0, 1, 1, 1, 1, 1], [1] * 6], np.int32)
    if kw.pop("segments", False):
        seg = np.array([[0, 0, 0, 1, 1, 1], [0, 0, 1, 1, 1, 2]], np.int32)
        kw.update(q_segment_ids=seg, kv_segment_ids=seg)
    tkw = {n: torch.as_tensor(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    t_probs, j_probs = [], []
    out = attention.eager_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                    q_positions=torch.as_tensor(qpos),
                                    kv_valid=torch.as_tensor(valid), probs_sink=t_probs, **tkw)
    ref = jax_attn.eager_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   q_positions=jnp.asarray(qpos), kv_valid=jnp.asarray(valid),
                                   probs_sink=j_probs, **jkw)
    _assert_close(out, ref, F32_TOL)
    _assert_close(t_probs[0], j_probs[0], F32_TOL)


@pytest.mark.parametrize("window", [None, 4], ids=["full", "window"])
def test_cached_attention_bhsd_matches_jax(window):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 3, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    qpos = np.array([[7, 8, 9], [7, 8, 9]], np.int32)
    valid = np.ones((2, 12), np.int32)
    valid[0, :3] = 0
    valid[:, 10:] = 0
    out = attention.cached_attention_bhsd(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        q_positions=torch.as_tensor(qpos), kv_valid=torch.as_tensor(valid),
        sliding_window=window)
    ref = jax_attn.cached_attention_bhsd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_positions=jnp.asarray(qpos),
        kv_valid=jnp.asarray(valid), sliding_window=window)
    _assert_close(out, ref, F32_TOL)
