"""The port's flash-attention backward (K5 dQ, K4 dK/dV) on the CPU, against
the JAX package.

On CPU tensors the backward wrappers run their plain PyTorch version
(``flash_attention_bwd_plain``); the JAX package runs its Pallas backward
(``_flash_bwd``) in interpret mode, as its own tests do on the CPU. Both get
the same numpy q, k, v and dO, and the plain backward gets JAX's own forward
output and logsumexp, so the comparison holds the backward alone.

Cases: those of ``tests/ops/test_flash_attention.py``
(``test_flash_bwd_kernel_parity``: GQA 4/2, ``kv_valid`` holes, window 37,
softcap 30; ``test_flash_grad_matches_eager``). Tolerance 2e-4, as there:
gradients are sums over up to 192 slots of f32 products, summed in another
order by each side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformers_tpu.ops.pallas import flash_attention as jax_fa
from transformers_tpu_torch.ops import flash_attention as port_fa
from transformers_tpu_torch.ops.fused_decode import fused_decode_attention
from transformers_tpu_torch.ops.paged_attention import paged_decode_attention
from torch_port_testing import one_torch_thread  # noqa: F401

TOL = 2e-4
# name: (b, sq, skv, h, kvh, d, window, cap, kv holes of row 1)
CASES = {
    "gqa_holes": (2, 128, 192, 4, 2, 64, None, None, 23),
    "gqa_holes_window_37": (2, 128, 192, 4, 2, 64, 37, None, 23),
    "gqa_holes_cap_30": (2, 128, 192, 4, 2, 64, None, 30.0, 23),
    "grad_matches_eager": (1, 64, 64, 2, 2, 64, None, None, 0),
    "head_dim_96_window_37": (2, 128, 192, 4, 2, 96, 37, None, 23),
}
BWD_CASES = ["gqa_holes", "gqa_holes_window_37", "gqa_holes_cap_30"]


def _inputs(name, seed=0):
    b, sq, skv, h, kvh, d, window, cap, holes = CASES[name]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, kvh, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    qpos = np.broadcast_to((skv - sq) + np.arange(sq, dtype=np.int32), (b, sq)).copy()
    valid = np.ones((b, skv), np.int32)
    if holes:
        valid[1, :holes] = 0
    kw = dict(scale=d ** -0.5, is_causal=True, sliding_window=window, logit_cap=cap)
    return q, k, v, do, qpos, valid, kw


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.fixture(scope="module")
def jax_backward():
    """Per case: JAX's forward output and lse, and its backward of a random dO."""
    out = {}
    for name in BWD_CASES:
        q, k, v, do, qpos, valid, kw = _inputs(name)
        args = [jnp.asarray(a) for a in (q, k, v, qpos, valid)]
        o, lse = jax_fa._flash_fwd(*args, **kw, block_q=512, block_kv=512)
        grads = jax_fa._flash_bwd(*args, o, lse, jnp.asarray(do), **kw, block_q=512,
                                  block_kv=512)
        out[name] = (np.asarray(o), np.asarray(lse), [np.asarray(g) for g in grads])
    return out


@pytest.mark.parametrize("name", BWD_CASES)
def test_plain_backward_matches_jax_flash_bwd(jax_backward, name):
    q, k, v, do, qpos, valid, kw = _inputs(name)
    o, lse, ref = jax_backward[name]
    got = port_fa.flash_attention_bwd_plain(*_t(q, k, v, qpos, valid, o, lse, do), **kw)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), r, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_flash_attention_grads_match_jax_grad(name):
    """d/d(q, k, v) of sum(out ** 2) through the port's autograd.Function,
    against jax.grad of the JAX flash_attention (custom_vjp)."""
    q, k, v, _, qpos, valid, kw = _inputs(name)
    scale = kw.pop("scale")
    kw.pop("is_causal")

    def loss_jax(q, k, v):
        return jnp.sum(jax_fa.flash_attention(q, k, v, q_positions=jnp.asarray(qpos),
                                              kv_valid=jnp.asarray(valid), scale=scale,
                                              **kw) ** 2)

    ref = jax.grad(loss_jax, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = port_fa.flash_attention(tq, tk, tv, q_positions=torch.from_numpy(qpos),
                                  kv_valid=torch.from_numpy(valid), scale=scale, **kw)
    assert out.grad_fn is not None
    (out ** 2).sum().backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=TOL)


def test_left_pad_query_rows_get_zero_dq():
    """Rows 0-4 of a left-padded row see no slot: their output and dQ are 0,
    their dO reaches nothing, and the other rows' gradients equal autograd
    through the eager reference with those rows' dO zeroed."""
    from transformers_tpu.ops.attention import eager_attention
    from transformers_tpu.ops.masks import causal_mask_bool, to_additive

    rng = np.random.default_rng(1)
    b, s, h, kvh, d, pads = 1, 64, 4, 2, 64, 5
    q, do = (rng.standard_normal((b, s, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, s, kvh, d)).astype(np.float32) for _ in range(2))
    qpos = np.arange(s, dtype=np.int32)[None]
    valid = np.ones((b, s), np.int32)
    valid[:, :pads] = 0

    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = port_fa.flash_attention(tq, tk, tv, q_positions=torch.from_numpy(qpos),
                                  kv_valid=torch.from_numpy(valid))
    out.backward(torch.from_numpy(do))
    assert torch.equal(out[:, :pads], torch.zeros_like(out[:, :pads]))
    assert torch.equal(tq.grad[:, :pads], torch.zeros_like(tq.grad[:, :pads]))
    for g in (tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(g).all()

    do_live = do.copy()
    do_live[:, :pads] = 0
    bias = to_additive(causal_mask_bool(jnp.asarray(qpos), jnp.asarray(valid)))
    _, vjp = jax.vjp(lambda q, k, v: eager_attention(q, k, v, bias), jnp.asarray(q),
                     jnp.asarray(k), jnp.asarray(v))
    ref = vjp(jnp.asarray(do_live))
    for g, r in zip((tq.grad[:, pads:], tk.grad, tv.grad), (ref[0][:, pads:], *ref[1:])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=TOL, rtol=TOL)


def test_decode_wrappers_raise_when_a_gradient_is_needed():
    """The decode kernels have no backward (nor do the Pallas ones): with an
    input that requires grad they raise instead of cutting the graph; under
    no_grad they run."""
    g = torch.Generator().manual_seed(0)
    b, h, kvh, d, s = 2, 4, 2, 64, 16
    q = torch.randn((b, 1, h, d), generator=g, requires_grad=True)
    kn, vn = (torch.randn((b, 1, kvh, d), generator=g) for _ in range(2))
    cos, sin = torch.ones((b, 1, d)), torch.zeros((b, 1, d))
    kc, vc = (torch.randn((b, kvh, s, d), generator=g) for _ in range(2))
    start = torch.zeros(b, dtype=torch.int32)
    valid = torch.ones((b, s), dtype=torch.int32)
    decode_args = (q, kn, vn, cos, sin, kc, vc, 5, start, valid)
    k_pool, v_pool = (torch.randn((3, kvh, 8, d), generator=g) for _ in range(2))
    tables = torch.tensor([[1, 2], [2, 0]], dtype=torch.int32)
    ctx = torch.tensor([12, 3], dtype=torch.int32)
    paged_args = (q, k_pool, v_pool, tables, ctx)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_decode_attention(*decode_args, scale=d ** -0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        paged_decode_attention(*paged_args, scale=d ** -0.5)
    with torch.no_grad():
        assert fused_decode_attention(*decode_args, scale=d ** -0.5).shape == (b, 1, h, d)
        assert paged_decode_attention(*paged_args, scale=d ** -0.5).shape == (b, 1, h, d)
