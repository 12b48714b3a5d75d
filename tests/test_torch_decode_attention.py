"""The port's static-cache decode op (K7) against the JAX package's, on the CPU.

``decode_attention``'s wrapper (on CPU tensors: ``decode_attention_plain``)
against JAX ``decode_attention``, whose Pallas kernel runs in interpret mode
on the CPU, on the three cases of tests/ops/test_decode_attention.py (a
left-padded row and a live region that ends mid-buffer, a sliding window of
128, a 5-slot context), with their shapes and seeds, plus GQA groups of 1 and
8, head_dim 64 and 256, a row whose ``valid_end`` lies before its
``valid_start`` (zeros), and one bf16 case. Inputs are made from a seed with
numpy.

The empty row sits in a kv block of its own (slots 300 > 200 with the
Pallas kernel's 256-slot blocks), where the Pallas kernel skips the block and
gives zeros as the port does; inside a block it would average that block's V
(see ``transformers_tpu_torch/ops/decode_attention.py``).

The kernel cuts each row's slots into splits and merges their f32 (m, l,
acc) partials in split order; ``decode_split_plain`` is that computation in
plain PyTorch, held at split sizes 16/32/64/128 (rows inside one split, rows
over many, a window that starts inside a split, an empty row) to
``decode_attention_plain`` and to the JAX kernel, whose outputs are computed
once per module.

Tolerances: 2e-5 in float32 (sums in another order), 1e-5 for the split
version against the plain one (f32 sums over the same slots, split
otherwise); 2e-2 in bf16, one rounding step of bf16 at the outputs'
magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformers_tpu.ops.pallas.decode_attention import decode_attention as jax_decode
from transformers_tpu_torch.ops.decode_attention import (
    decode_attention,
    decode_attention_plain,
    decode_split_plain,
    decode_supported,
)
from torch_port_testing import one_torch_thread  # noqa: F401

F32_TOL = 2e-5
SPLIT_F32_TOL = 1e-5
BF16_TOL = 2e-2
SPLITS = (16, 32, 64, 128)

CASES = {
    # name: (b, s, h, kvh, d, starts, ends, window, dtype, seed)
    "matches_eager": (2, 512, 8, 2, 128, (0, 64), (300, 400), None, "float32", 0),
    "sliding_window": (2, 512, 8, 2, 128, (0, 0), (500, 200), 128, "float32", 1),
    "small_context": (1, 256, 8, 2, 128, (0,), (5,), None, "float32", 2),
    # not in the reference file
    "gqa_1": (2, 256, 4, 4, 128, (3, 0), (200, 77), None, "float32", 3),
    "gqa_8": (2, 256, 16, 2, 128, (0, 31), (256, 140), 64, "float32", 4),
    "head_dim_64": (2, 256, 8, 2, 64, (10, 0), (250, 33), None, "float32", 5),
    "head_dim_256": (2, 128, 4, 1, 256, (0, 17), (128, 90), 40, "float32", 6),
    "head_dim_96": (2, 128, 8, 2, 96, (0, 17), (128, 90), 40, "float32", 9),
    "end_before_start": (2, 512, 8, 2, 128, (300, 7), (200, 411), None, "float32", 7),
    "bf16": (2, 256, 8, 2, 128, (0, 40), (256, 180), None, "bfloat16", 8),
}


def _inputs(name):
    b, s, h, kvh, d, starts, ends, window, dtype, seed = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    port = [torch.from_numpy(x).to(tdt) for x in (q, k, v)]
    # JAX gets the values the port's tensors hold
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jax_in = [jnp.asarray(t.float().numpy()).astype(jdt) for t in port]
    return (port, jax_in, np.asarray(starts, np.int32), np.asarray(ends, np.int32),
            dict(scale=d ** -0.5, sliding_window=window))


@pytest.fixture(scope="module")
def jax_outputs():
    """JAX's output for every case, computed once."""
    outs = {}
    for case in CASES:
        _, (jq, jk, jv), starts, ends, kw = _inputs(case)
        outs[case] = jax_decode(jq, jk, jv, jnp.asarray(starts), jnp.asarray(ends), **kw)
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_decode_plain_matches_jax_pallas(jax_outputs, case):
    (q, k, v), _, starts, ends, kw = _inputs(case)
    ref = jax_outputs[case]
    before = decode_attention.launches
    out = decode_attention(q, k, v, torch.from_numpy(starts), torch.from_numpy(ends), **kw)
    assert decode_attention.launches == before  # CPU tensors never count a launch
    assert out.shape == q.shape and out.dtype == q.dtype
    tol = BF16_TOL if q.dtype == torch.bfloat16 else F32_TOL
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)
    if case == "end_before_start":
        assert not out[0].any()


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", list(CASES))
def test_decode_split_plain_matches_plain_and_jax_pallas(jax_outputs, case, split):
    (q, k, v), _, starts, ends, kw = _inputs(case)
    args = (q, k, v, torch.from_numpy(starts), torch.from_numpy(ends))
    out = decode_split_plain(*args, **kw, split_slots=split)
    ref = decode_attention_plain(*args, **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = SPLIT_F32_TOL if q.dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=tol, rtol=tol)
    tol = max(tol, F32_TOL)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jax_outputs[case], np.float32),
                               atol=tol, rtol=tol)
    if case == "end_before_start":
        assert not out[0].any()


@pytest.mark.parametrize("case", ["matches_eager", "sliding_window", "bf16"])
def test_decode_split_plain_is_bitwise_repeatable(case):
    (q, k, v), _, starts, ends, kw = _inputs(case)
    args = (q, k, v, torch.from_numpy(starts), torch.from_numpy(ends))
    assert torch.equal(decode_split_plain(*args, **kw, split_slots=16),
                       decode_split_plain(*args, **kw, split_slots=16))


def test_decode_supported_has_no_head_dim_128_gate():
    q = torch.zeros(2, 1, 8, 64)
    assert decode_supported(q, torch.zeros(2, 16, 2, 64))
    assert not decode_supported(q, torch.zeros(2, 16, 3, 64))  # 8 heads over 3 kv heads
    assert not decode_supported(torch.zeros(2, 2, 8, 64), torch.zeros(2, 16, 2, 64))


def test_decode_attention_refuses_grad():
    q = torch.zeros(1, 1, 2, 64, requires_grad=True)
    k = torch.zeros(1, 8, 1, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        decode_attention(q, k, k, torch.zeros(1), torch.ones(1), scale=0.125)
