"""The port's mixture-of-experts op (``transformers_tpu_torch/ops/moe.py``)
against the JAX package's ``transformers_tpu/ops/moe.py`` on the CPU, float32.

Inputs are made from a numpy seed. ``topk_routing``'s indices must equal
``jax.lax.top_k``'s exactly (a planted tie included) and its weights agree
within 1e-6; the ``dense`` and ``ragged`` routes each agree with JAX's
``dense_experts_forward`` / ``ragged_experts_forward`` within 2e-5 (the two
frameworks sum in different orders), with an expert that no token picks and
T·k not a multiple of E, and the weights given as the port passes them:
transposed views of ``[E, out, in]`` parameters. The ragged route repeats
bit for bit, sums each token's k rows in float32 rounded once (checked in
bf16), and runs no op that reads the card back to the host; its padded
product (the card's route for types other than bf16) equals the grouped
one. ``quantize_params`` refuses a model with stacked experts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import transformers_tpu_torch as port
from transformers_tpu.ops import moe as jax_moe
from transformers_tpu_torch.ops import moe
from torch_port_testing import one_torch_thread  # noqa: F401

TOL = 2e-5


def _inputs(t=13, h=16, i=24, e=6, k=2, seed=0, unused=5):
    """x [T, H], the weights in the JAX layout [E, in, out], router logits
    [T, E] with expert ``unused`` never among a token's top k."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, h)).astype(np.float32)
    w_gate = (0.2 * rng.standard_normal((e, h, i))).astype(np.float32)
    w_up = (0.2 * rng.standard_normal((e, h, i))).astype(np.float32)
    w_down = (0.2 * rng.standard_normal((e, i, h))).astype(np.float32)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    if unused is not None:
        logits[:, unused] = -10.0
    return x, w_gate, w_up, w_down, logits


def _port_weights(*ws):
    """The JAX-layout [E, in, out] arrays as the port passes them: transposed
    views of contiguous [E, out, in] tensors."""
    return [torch.from_numpy(np.ascontiguousarray(w.transpose(0, 2, 1))).transpose(1, 2)
            for w in ws]


@pytest.mark.parametrize("pre_softmax", [True, False])
@pytest.mark.parametrize("renormalize", [True, False])
def test_topk_routing_matches_jax(pre_softmax, renormalize):
    *_, logits = _inputs(t=20, e=8, seed=1, unused=None)
    logits[3, [1, 6]] = logits[3].max() + 1.0  # a tie for the first place: lower index first
    logits[7, [0, 2, 5]] = 2.5
    kw = dict(renormalize=renormalize, pre_softmax=pre_softmax)
    ref_w, ref_idx = jax_moe.topk_routing(jnp.asarray(logits), 3, **kw)
    w, idx = moe.topk_routing(torch.from_numpy(logits), 3, **kw)
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), atol=1e-6, rtol=0)
    assert idx[3, :2].tolist() == [1, 6]


@pytest.mark.parametrize("route", ["dense", "ragged"])
@pytest.mark.parametrize("t,k", [(13, 2), (7, 3)])
def test_routes_match_jax(route, t, k):
    """T·k (26, 21) not a multiple of E (6); expert 5 takes no token."""
    x, wg, wu, wd, logits = _inputs(t=t, k=k)
    ref_fn = {"dense": jax_moe.dense_experts_forward,
              "ragged": jax_moe.ragged_experts_forward}[route]
    jw, jidx = jax_moe.topk_routing(jnp.asarray(logits), k)
    ref = ref_fn(*map(jnp.asarray, (x, wg, wu, wd)), jw, jidx, jax.nn.silu)
    w, idx = moe.topk_routing(torch.from_numpy(logits), k)
    assert 5 not in idx.tolist()
    out = moe.get_experts_fn(route)(torch.from_numpy(x), *_port_weights(wg, wu, wd), w, idx,
                                    F.silu)
    err = float(np.abs(out.numpy() - np.asarray(ref)).max())
    assert err < TOL, f"{route}: max |port - jax| = {err}"


def test_registry_keys_and_default():
    assert moe.get_experts_fn(None) is moe.dense_experts_forward
    assert moe.get_experts_fn("batched_mm") is moe.dense_experts_forward
    assert moe.get_experts_fn("grouped_mm") is moe.ragged_experts_forward
    assert sorted(moe.EXPERTS_FUNCTIONS) == sorted(jax_moe.ALL_EXPERTS_FUNCTIONS.valid_keys())
    with pytest.raises(KeyError, match="megablox"):
        moe.get_experts_fn("megablox")


def _ragged_case(dtype=torch.float32):
    x, wg, wu, wd, logits = _inputs(t=11, k=3)
    w, idx = moe.topk_routing(torch.from_numpy(logits), 3)
    return (torch.from_numpy(x).to(dtype), *(p.to(dtype) for p in _port_weights(wg, wu, wd)),
            w, idx, F.silu)


def test_ragged_route_repeats_bitwise_and_reads_nothing_back():
    """Two runs give the same bits. Every op the route dispatches is recorded:
    no ``bincount`` (which reads its maximum back on the card), no op that
    copies a value to the host (``item``/``tolist`` are ``_local_scalar_dense``)
    or whose output shape depends on the data, and the group offsets are a
    tensor made by ``searchsorted``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ops.append(func.overloadpacket.__name__)
            if func.overloadpacket.__name__ == "_grouped_mm":
                offs = kwargs.get("offs") if kwargs else args[2]
                assert isinstance(offs, torch.Tensor) and offs.dtype == torch.int32
            return func(*args, **(kwargs or {}))

    args = _ragged_case()
    with Record():
        first = moe.ragged_experts_forward(*args)
    assert torch.equal(first, moe.ragged_experts_forward(*args))
    assert "searchsorted" in ops and ops.count("_grouped_mm") == 3 and "sort" in ops
    syncing = {"bincount", "_local_scalar_dense", "nonzero", "masked_select", "unique",
               "_unique2", "repeat_interleave", "index_add", "index_add_", "scatter_add",
               "scatter_add_", "index_put_"}
    assert not syncing & set(ops), sorted(syncing & set(ops))


def test_ragged_route_sums_in_float32_rounded_once():
    """bf16: each token's output is its k expert rows times the weights
    (rounded to bf16), summed in float32 in routing order and rounded once."""
    x, wg, wu, wd, w, idx, act = _ragged_case(torch.bfloat16)
    out = moe.ragged_experts_forward(x, wg, wu, wd, w, idx, act)
    want = torch.zeros(out.shape, dtype=torch.float32)
    for j in range(idx.shape[1]):
        e = idx[:, j]
        gate = torch.bmm(x[:, None, :], wg[e])[:, 0]
        up = torch.bmm(x[:, None, :], wu[e])[:, 0]
        rows = torch.bmm((act(gate) * up)[:, None, :], wd[e])[:, 0]
        want += rows.float() * w[:, j, None].to(torch.bfloat16).float()
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, want.to(torch.bfloat16))


def test_padded_product_equals_grouped_product():
    """The per-expert padded product (the card's route for types other than
    bf16) gives the grouped product's rows, an empty group included."""
    x, wg, *_ = _ragged_case()
    idx = torch.tensor([[0, 2], [2, 3], [0, 3], [2, 0], [3, 2]])  # expert 1 takes no token
    sorted_expert, order = torch.sort(idx.reshape(-1), stable=True)
    xs = x[:5].index_select(0, order // 2)
    experts = torch.arange(wg.shape[0])
    ends = torch.searchsorted(sorted_expert, experts, right=True).to(torch.int32)
    starts = torch.searchsorted(sorted_expert, experts)
    grouped = torch._grouped_mm(xs, wg, offs=ends)
    padded = moe._grouped_mm_padded(xs, wg, sorted_expert, starts, 5)
    torch.testing.assert_close(padded, grouped, atol=1e-6, rtol=1e-6)


def test_quantize_params_refuses_stacked_experts():
    config = port.Qwen3MoeConfig(vocab_size=64, hidden_size=32, intermediate_size=48,
                                 num_hidden_layers=1, num_attention_heads=4,
                                 num_key_value_heads=2, head_dim=8, num_experts=4,
                                 num_experts_per_tok=2, moe_intermediate_size=16)
    model = port.Qwen3MoeForCausalLM(config, device="cpu")
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        port.quantize_params(model, port.Int8WeightOnlyConfig())
    assert all(getattr(m, "weight_scale", None) is None for m in model.modules())
