"""The PyTorch port's ops against the JAX package's, on the CPU.

- The flash kernel's wrapper (here: its plain PyTorch version) against JAX
  ``flash_attention``, whose Pallas kernel runs in interpret mode on the CPU,
  on the cases of tests/ops/test_flash_attention.py.
- The fused decode wrapper (plain version) against JAX
  ``fused_decode_attention(..., interpret=True)`` on the cases of
  tests/ops/test_fused_decode.py, updated caches included, plus a start
  moved up as a sliding window moves it, rows whose start lies at or past
  ``pos``, and a row whose holes cover whole splits. The kernel cuts each
  row's slots into splits and merges their f32 (m, l, acc) partials in
  split order, the new column last; ``fused_decode_split_plain`` is that
  computation in plain PyTorch, held at
  split sizes 16/32/64/128 (rows inside one split, rows over many, whole
  splits before ``start``) to ``fused_decode_plain`` and to the JAX kernel.
  The JAX outputs are computed once per module. ``pos`` as a tensor, as the
  static cache passes it, gives what the int gives.
- rope, RMSNorm, activations, masks, ``eager_attention`` and
  ``cached_attention_bhsd`` against their JAX counterparts.

Inputs are made from a seed with numpy. Tolerances: 2e-5 in float32 (sums in
another order), 1e-5 for the split version against the plain one (f32 sums
over the same slots, split otherwise); 2e-2 in bf16, one rounding step of
bf16 at the outputs' magnitude (the Pallas kernels also round probabilities
to bf16 before P.V, the port keeps them in f32).
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
from transformers_tpu.ops.pallas.flash_attention import _flash_fwd as jax_flash_fwd
from transformers_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from transformers_tpu.ops.pallas.fused_decode import fused_decode_attention as jax_fused_decode
from transformers_tpu_torch.core.module import RMSNorm
from transformers_tpu_torch.ops import activations, attention, masks, rope
from transformers_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_tiled_plain,
)
from transformers_tpu_torch.ops.fused_decode import (
    fused_decode_attention,
    fused_decode_plain,
    fused_decode_split_plain,
)
from transformers_tpu_torch.ops.paged_attention import merge_splits_plain
from torch_port_testing import one_torch_thread  # noqa: F401

F32_TOL = 2e-5
SPLIT_F32_TOL = 1e-5
BF16_TOL = 2e-2
SPLITS = (16, 32, 64, 128)


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
    # not in the reference file: Phi-3's head_dim 96, and Gemma's 256 under a window
    "d96_padded": (2, 64, 96, 4, 2, 96, torch.float32, (5, 0), None, None),
    "d256_window": (2, 48, 80, 4, 2, 256, torch.float32, (0, 9), 24, None),
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


# The bf16/f16 head_dim-256 kernel's tiling: ``flash_attention_tiled_plain``
# against the Pallas ``_flash_fwd`` (interpret mode) at the same kv tile of
# 64 slots. Both take f32 scores, round each tile's P once to bf16 under the
# same running max and sum the f32 P, so they differ only by the order of
# the f32 sums: a P that lands on the other side of a bf16 rounding moves an
# output by at most 2^-9 of its share of v, and two nearly equal outputs
# round at most one bf16 step apart (2^-8 of the value): 1e-2, absolute and
# relative (measured: under 4e-3; ``flash_attention_plain``, whose P stays
# f32, is 4x further from Pallas). The logsumexp comes from the f32 scores
# alone: F32_TOL. In float32 the tiling changes only the order of the sums:
# 1e-5 against ``flash_attention_plain``.
TILED_BF16_TOL = 1e-2
TILED_CASES = {
    # name: (b, sq, skv, h, kvh, dtype, left pads per row, window, cap)
    "window_left_pads": (2, 96, 160, 4, 2, torch.bfloat16, (17, 0), 40, None),
    "gqa_2_softcap_50": (1, 128, 128, 4, 2, torch.bfloat16, None, None, 50.0),
    "ragged_sq": (1, 70, 200, 2, 2, torch.bfloat16, (3,), None, None),
    "f32_window_softcap": (2, 80, 144, 4, 2, torch.float32, (0, 21), 48, 30.0),
}


@pytest.mark.parametrize("case", list(TILED_CASES))
def test_flash_tiled_plain_matches_jax_pallas(case):
    b, sq, skv, h, kvh, dtype, pads, window, cap = TILED_CASES[case]
    d, block = 256, 64
    rng = np.random.default_rng(len(case) + 7)
    jq, q = _pair(rng.standard_normal((b, sq, h, d)), dtype)
    jk, k = _pair(rng.standard_normal((b, skv, kvh, d)), dtype)
    jv, v = _pair(rng.standard_normal((b, skv, kvh, d)), dtype)
    qpos = np.broadcast_to(skv - sq + np.arange(sq, dtype=np.int32)[None], (b, sq)).copy()
    valid = np.ones((b, skv), np.int32)
    for row, p in enumerate(pads or ()):
        valid[row, :p] = 0
    kw = dict(scale=d ** -0.5, is_causal=True, sliding_window=window, logit_cap=cap)
    out, lse = flash_attention_tiled_plain(q, k, v, torch.as_tensor(qpos),
                                           torch.as_tensor(valid), block_kv=block, **kw)
    assert out.dtype == dtype and out.shape == (b, sq, h, d) and lse.shape == (b, h, sq)
    if dtype == torch.float32:
        ref, ref_lse = flash_attention_plain(q, k, v, torch.as_tensor(qpos),
                                             torch.as_tensor(valid), **kw)
        _assert_close(out, ref, SPLIT_F32_TOL)
        _assert_close(lse, ref_lse, SPLIT_F32_TOL)
        return
    ref, ref_lse = jax_flash_fwd(jq, jk, jv, jnp.asarray(qpos), jnp.asarray(valid), **kw,
                                 block_q=block, block_kv=block)
    _assert_close(out, ref, TILED_BF16_TOL)
    _assert_close(lse, np.asarray(ref_lse)[:, :, :sq], F32_TOL)


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
    # not in the reference file: a start moved up to pos + 1 - window (window 16),
    # as a sliding layer moves it, and starts at and past pos (the new column alone)
    "window_start": (3, 8, 2, 128, 96, 80, torch.float32, (65, 0, 70), ((1, 66), (2, 75))),
    "start_past_pos": (3, 8, 2, 64, 96, 40, torch.float32, (0, 40, 90), ()),
    # row 0's slots 32-99 are holes: whole splits with nothing live (m = -inf)
    "dead_splits": (2, 8, 2, 64, 160, 150, torch.float32, None,
                    tuple((0, j) for j in range(32, 100))),
    # Phi-3's head_dim 96; Gemma's 256 with a window of 16 (starts at pos + 1 - 16)
    "d96": (3, 8, 2, 96, 64, 50, torch.float32, (0, 7, 23), ((2, 40),)),
    "d256_window": (2, 8, 2, 256, 80, 70, torch.float32, (55, 55), ()),
}


def _decode_case(case):
    """The case's inputs, each as a (jax array, torch tensor) pair, and its
    pos, start and kv_valid as numpy."""
    b, h, kvh, d, s, pos, dtype, starts, holes = DECODE_CASES[case]
    rng = np.random.default_rng(len(case) + 100)
    pairs = [_pair(rng.standard_normal(shape), dtype) for shape in (
        (b, 1, h, d), (b, 1, kvh, d), (b, 1, kvh, d))]
    ang = rng.standard_normal((b, 1, d))
    pairs += [_pair(np.cos(ang), dtype), _pair(np.sin(ang), dtype)]
    pairs += [_pair(rng.standard_normal((b, kvh, s, d)), dtype) for _ in range(2)]
    start = np.zeros((b,), np.int32) if starts is None else np.asarray(starts, np.int32)
    valid = np.ones((b, s), np.int32)
    for bi, si in holes:
        valid[bi, si] = 0
    return pairs, pos, start, valid


@pytest.fixture(scope="module")
def jax_decode_outputs():
    """JAX's output and updated caches for every decode case, computed once."""
    outs = {}
    for case in DECODE_CASES:
        pairs, pos, start, valid = _decode_case(case)
        d = DECODE_CASES[case][3]
        outs[case] = jax_fused_decode(
            *(j for j, _ in pairs), jnp.asarray(pos, jnp.int32), jnp.asarray(start),
            jnp.asarray(valid), scale=d ** -0.5, interpret=True)
    return outs


def _torch_decode_args(case):
    """The port's arguments for the case: (q, k_new, v_new, cos, sin, k_cache,
    v_cache, pos, start, kv_valid), fresh caches each call."""
    pairs, pos, start, valid = _decode_case(case)
    return (*(t for _, t in pairs), pos, torch.as_tensor(start), torch.as_tensor(valid))


@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_fused_decode_plain_matches_jax_pallas(jax_decode_outputs, case):
    q, kn, vn, cos, sin, kc, vc, pos, start, valid = _torch_decode_args(case)
    dtype, d = DECODE_CASES[case][6], DECODE_CASES[case][3]
    ref, ref_kc, ref_vc = jax_decode_outputs[case]
    before = fused_decode_attention.launches
    out = fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos, start, valid, scale=d ** -0.5)
    assert fused_decode_attention.launches == before
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    _assert_close(out, ref, tol)
    _assert_close(kc, ref_kc, tol)  # caches updated in place at slot pos
    _assert_close(vc, ref_vc, tol)
    if case == "start_past_pos":  # rows 1 and 2 see only the new column: its value
        g = q.shape[2] // kn.shape[2]
        want = vn[1:, 0].repeat_interleave(g, dim=1)
        np.testing.assert_allclose(out[1:, 0].numpy(), want.numpy(), atol=F32_TOL, rtol=F32_TOL)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_fused_decode_split_plain_matches_plain_and_jax_pallas(jax_decode_outputs, case, split):
    args = _torch_decode_args(case)
    d = DECODE_CASES[case][3]
    kc, vc = args[5].clone(), args[6].clone()
    out = fused_decode_split_plain(*args, scale=d ** -0.5, split_slots=split)
    ref = fused_decode_plain(*args[:5], kc, vc, *args[7:], scale=d ** -0.5)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    assert torch.equal(args[5], kc) and torch.equal(args[6], vc)  # the same cache writes
    tol = SPLIT_F32_TOL if out.dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=tol, rtol=tol)
    _assert_close(out, jax_decode_outputs[case][0], max(tol, F32_TOL))


@pytest.mark.parametrize("case", ["left_padding_starts", "mask_holes", "chunked_long_context"])
def test_fused_decode_split_plain_is_bitwise_repeatable(case):
    d = DECODE_CASES[case][3]
    first = fused_decode_split_plain(*_torch_decode_args(case), scale=d ** -0.5, split_slots=16)
    again = fused_decode_split_plain(*_torch_decode_args(case), scale=d ** -0.5, split_slots=16)
    assert torch.equal(first, again)


def test_fused_decode_merge_sums_in_split_order_new_column_last():
    """Four live splits and the new column, all with m = 0 (weights exactly 1),
    whose f32 sum depends on the order: 1e8 + 1 - 1e8 + 1, then the new
    column's 1, is 2; with the new column first it is 1, and right to left 0.
    The merge gives 2 / 5."""
    ml = torch.tensor([[[[0.0, 1.0]] * 4]])  # [N=1, H=1, 4 splits, (m, l)]
    acc = torch.tensor([[[[1e8], [1.0], [-1e8], [1.0]]]])  # [1, 1, 4, D=1]
    new = (torch.zeros((1, 1)), torch.ones((1, 1, 1)))
    out = merge_splits_plain(ml, acc, torch.tensor([0]), torch.tensor([4]), new=new)
    assert out.item() == np.float32(2.0) / np.float32(5.0)


def test_fused_decode_pos_tensor_equals_int():
    """``pos`` as a one-element int32 tensor, as the static cache passes it,
    gives the output and cache writes that the int gives."""
    case = "left_padding_starts"
    d = DECODE_CASES[case][3]
    by_int = _torch_decode_args(case)
    by_tensor = _torch_decode_args(case)
    pos = by_int[7]
    out_int = fused_decode_attention(*by_int, scale=d ** -0.5)
    out_t = fused_decode_attention(*by_tensor[:7], torch.tensor([pos], dtype=torch.int32),
                                   *by_tensor[8:], scale=d ** -0.5)
    assert torch.equal(out_int, out_t)
    assert torch.equal(by_int[5], by_tensor[5]) and torch.equal(by_int[6], by_tensor[6])


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
