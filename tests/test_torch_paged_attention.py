"""The port's paged decode op (K6) against the JAX package's, on the CPU.

``paged_decode_attention``'s wrapper (on CPU tensors: ``paged_decode_plain``)
against JAX ``paged_decode_attention(..., interpret=True)`` on the cases of
tests/ops/test_paged_attention.py (GQA 1/4/8, a one-token context, contexts
over several page groups, ragged rows, head_dim 64, windows 16/40/128, bf16
pools), with their shapes, block sizes and seeds, plus a row with ctx 0
(zeros) and a pad row that reads slot 0 of the null page.

Interpret mode costs seconds of tracing per distinct call, so the JAX side
runs one call per (head_dim, block size, dtype, window): each case's rows,
pages and heads are laid side by side in one larger call, whose kv heads
and query-head groups are padded with zeros. Every (row, query head) of the
Pallas kernel reads only its own kv head's pages, and the kernel pads its
query-head group to 8 itself, so each case's slice of the output is what
the case alone gives. The port runs each case on its own.

The kernel cuts each row's slots into splits and merges the splits' f32
(m, l, acc) partials in split order; ``paged_decode_split_plain`` is that
computation in plain PyTorch. It is held, at split sizes 16/32/64/128, to
``paged_decode_plain`` and to the JAX kernel on the same cases: ctx 0, a
one-slot context, rows over many splits, and windows whose start falls
inside a split with whole splits before it (window 40 at ctx 100 starts at
slot 60). The merge's order is checked on partials whose f32 sum depends on
it.

Tolerances: 2e-5 in float32 (sums in another order), 1e-5 for the split
version (f32 sums over the same slots, split otherwise); 2e-2 in bf16, one
rounding step at the outputs' magnitude (the Pallas kernel rounds the
probabilities to bf16 before P.V, the port keeps them in f32).
"""

from collections import defaultdict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformers_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode,
)
from transformers_tpu_torch.ops.paged_attention import (
    paged_decode_attention,
    paged_decode_combine,
    paged_decode_merge_plain,
    paged_decode_partials_plain,
    paged_decode_plain,
    paged_decode_split_plain,
)
from torch_port_testing import one_torch_thread  # noqa: F401

F32_TOL = 2e-5
SPLIT_F32_TOL = 1e-5
BF16_TOL = 2e-2
SPLITS = (16, 32, 64, 128)

CASES = {
    # name: (n, h, kvh, d, block_size, ctx_lens, window, dtype, seed)
    "gqa_1": (3, 8, 8, 128, 16, (40, 16, 61), None, "float32", 88),
    "gqa_4": (3, 8, 2, 128, 16, (40, 16, 61), None, "float32", 82),
    "gqa_8": (3, 16, 2, 128, 16, (40, 16, 61), None, "float32", 162),
    "single_token_context": (2, 4, 4, 128, 16, (1, 33), None, "float32", 3),
    "many_page_groups": (2, 8, 2, 128, 16, (296, 219), None, "float32", 4),
    "ragged": (5, 8, 4, 128, 32, (32, 1, 317, 64, 200), None, "float32", 5),
    "head_dim_64": (5, 8, 4, 64, 32, (32, 1, 317, 64, 200), None, "float32", 5),
    "window_16": (3, 8, 2, 128, 16, (100, 48, 32), 16, "float32", 16),
    "window_40": (3, 8, 2, 128, 16, (100, 48, 32), 40, "float32", 40),
    "window_128": (3, 8, 2, 128, 16, (100, 48, 32), 128, "float32", 128),
    "bf16_pools": (3, 8, 2, 128, 16, (130, 7, 256), None, "bfloat16", 7),
    # not in the reference file: a row with no context, and a pad row of a
    # decode bucket (ctx 1 on the null page, which holds pad writes)
    "ctx_0": (2, 8, 2, 128, 16, (0, 40), None, "float32", 11),
    "pad_row": (2, 8, 2, 128, 16, (1, 40), None, "float32", 12),
    # Phi-3's head_dim 96, and Gemma's 256 under a window
    "head_dim_96": (3, 8, 2, 96, 16, (40, 16, 61), None, "float32", 96),
    "head_dim_256_window": (3, 4, 2, 256, 16, (100, 48, 32), 40, "float32", 256),
}


def _build(name):
    """The case's inputs as numpy f32, made as tests/ops/test_paged_attention.py
    makes them: shuffled pages, page 0 the null page (zero, except in
    ``pad_row`` where pad writes have filled it and row 0 reads it)."""
    n, h, kvh, d, bs, ctx_lens, _, _, seed = CASES[name]
    rng = np.random.default_rng(seed)
    maxb = max(-(-c // bs) for c in ctx_lens)
    p = sum(-(-c // bs) for c in ctx_lens) + 1
    k_pool = rng.normal(size=(p, kvh, bs, d)).astype(np.float32)
    v_pool = rng.normal(size=(p, kvh, bs, d)).astype(np.float32)
    if name != "pad_row":
        k_pool[0] = 0.0
        v_pool[0] = 0.0
    perm = rng.permutation(np.arange(1, p))
    tables = np.zeros((n, maxb), np.int32)
    nxt = 0
    for i, c in enumerate(ctx_lens):
        need = -(-c // bs)
        tables[i, :need] = perm[nxt:nxt + need]
        nxt += need
    if name == "pad_row":
        tables[0] = 0
    q = rng.normal(size=(n, 1, h, d)).astype(np.float32)
    return q, k_pool, v_pool, tables, np.asarray(ctx_lens, np.int32)


def _jax_bundle(names):
    """One JAX call over the cases ``names`` (same head_dim, block size, dtype
    and window) laid side by side; returns each case's output, [n, 1, h, d]."""
    _, _, _, d, bs, _, window, dtype, _ = CASES[names[0]]
    built = {name: _build(name) for name in names}
    kvh = max(CASES[m][2] for m in names)
    g = max(CASES[m][1] // CASES[m][2] for m in names)
    rows = sum(CASES[m][0] for m in names)
    pages = 1 + sum(b[1].shape[0] - 1 for b in built.values())
    maxb = max(b[3].shape[1] for b in built.values())
    q = np.zeros((rows, kvh, g, d), np.float32)
    k_pool = np.zeros((pages, kvh, bs, d), np.float32)
    v_pool = np.zeros_like(k_pool)
    tables = np.zeros((rows, maxb), np.int32)
    ctx = np.zeros((rows,), np.int32)
    spans = {}
    row = page = 0
    for name in names:
        cq, ck, cv, ct, cc = built[name]
        n, h, ckvh = CASES[name][:3]
        cg = h // ckvh
        q[row:row + n, :ckvh, :cg] = cq.reshape(n, ckvh, cg, d)
        k_pool[page + 1:page + ck.shape[0], :ckvh] = ck[1:]
        v_pool[page + 1:page + cv.shape[0], :ckvh] = cv[1:]
        k_pool[0, :ckvh] += ck[0]  # null pages: all zero but pad_row's
        v_pool[0, :ckvh] += cv[0]
        tables[row:row + n, :ct.shape[1]] = np.where(ct > 0, ct + page, 0)
        ctx[row:row + n] = cc
        spans[name] = (row, n, h, ckvh, cg)
        row += n
        page += ck.shape[0] - 1
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jax_paged_decode(
        jnp.asarray(q.reshape(rows, 1, kvh * g, d), jdt), jnp.asarray(k_pool, jdt),
        jnp.asarray(v_pool, jdt), jnp.asarray(tables), jnp.asarray(ctx), scale=d ** -0.5,
        sliding_window=window, interpret=True)
    out = np.asarray(out, np.float32).reshape(rows, kvh, g, d)
    return {name: out[r:r + n, :ckvh, :cg].reshape(n, 1, h, d)
            for name, (r, n, h, ckvh, cg) in spans.items()}


@pytest.fixture(scope="module")
def jax_outputs():
    groups = defaultdict(list)
    for name, (_, _, _, d, bs, _, window, dtype, _) in CASES.items():
        groups[(d, bs, window, dtype)].append(name)
    outs = {}
    for names in groups.values():
        outs.update(_jax_bundle(names))
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_paged_decode_plain_matches_jax_pallas(jax_outputs, case):
    dtype = torch.bfloat16 if CASES[case][7] == "bfloat16" else torch.float32
    q, k_pool, v_pool, tables, ctx = (torch.as_tensor(x) for x in _build(case))
    q, k_pool, v_pool = q.to(dtype), k_pool.to(dtype), v_pool.to(dtype)
    d, window = q.shape[-1], CASES[case][6]
    before = paged_decode_attention.launches
    out = paged_decode_attention(q, k_pool, v_pool, tables, ctx, scale=d ** -0.5,
                                 sliding_window=window)
    assert paged_decode_attention.launches == before  # CPU tensors never reach the kernel
    assert out.dtype == dtype and out.shape == q.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), jax_outputs[case], atol=tol, rtol=tol)
    if case == "ctx_0":
        assert torch.all(out[0] == 0)
    if case == "pad_row":  # one live slot: its value row, for every query head
        h, kvh = q.shape[2], k_pool.shape[1]
        want = v_pool[0, :, 0].repeat_interleave(h // kvh, dim=0)
        np.testing.assert_allclose(out[0, 0].numpy(), want.numpy(), atol=F32_TOL, rtol=F32_TOL)


def _torch_case(case):
    dtype = torch.bfloat16 if CASES[case][7] == "bfloat16" else torch.float32
    q, k_pool, v_pool, tables, ctx = (torch.as_tensor(x) for x in _build(case))
    kw = dict(scale=q.shape[-1] ** -0.5, sliding_window=CASES[case][6])
    return (q.to(dtype), k_pool.to(dtype), v_pool.to(dtype), tables, ctx), kw


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("case", list(CASES))
def test_paged_decode_split_plain_matches_plain_and_jax_pallas(jax_outputs, case, split):
    args, kw = _torch_case(case)
    out = paged_decode_split_plain(*args, **kw, split_slots=split)
    ref = paged_decode_plain(*args, **kw)
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    tol = SPLIT_F32_TOL if out.dtype == torch.float32 else BF16_TOL
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=tol, rtol=tol)
    np.testing.assert_allclose(out.float().numpy(), jax_outputs[case], atol=tol, rtol=tol)
    if case == "ctx_0":
        assert torch.all(out[0] == 0)


@pytest.mark.parametrize("case", ["many_page_groups", "window_40", "bf16_pools"])
def test_paged_decode_split_plain_is_bitwise_repeatable(case):
    args, kw = _torch_case(case)
    first = paged_decode_split_plain(*args, **kw, split_slots=16)
    again = paged_decode_split_plain(*args, **kw, split_slots=16)
    assert torch.equal(first, again)


def test_paged_decode_merge_sums_in_split_order():
    """Four live splits with m = 0 (weights exactly 1) and accumulators whose
    f32 sum depends on the order: 1e8 + 1 - 1e8 + 1 is 1 left to right and 0
    right to left. The merge gives (left to right) / 4."""
    split = 16
    ml = torch.tensor([[[[0.0, 1.0]] * 4]])  # [N=1, H=1, 4 splits, (m, l)]
    acc = torch.tensor([[[[1e8], [1.0], [-1e8], [1.0]]]])  # [1, 1, 4, D=1]
    ctx = torch.tensor([4 * split], dtype=torch.int32)
    out = paged_decode_merge_plain(ml, acc, ctx, max_slots=4 * split, split_slots=split)
    assert out.item() == 0.25
    # the merge kernel's wrapper takes CUDA tensors only: no second CPU path
    with pytest.raises(ValueError, match="cuda"):
        paged_decode_combine(ctx, ml, acc, torch.zeros((1, 1, 1, 1)), max_slots=4 * split,
                             split_slots=split)


def test_paged_decode_combine_writes_only_rows_over_several_splits():
    args, kw = _torch_case("ragged")  # ctx (32, 1, 317, 64, 200), pages of 32
    split = 64
    ml, acc = paged_decode_partials_plain(*args, **kw, split_slots=split)
    max_slots = args[3].shape[1] * args[1].shape[2]
    merged = paged_decode_merge_plain(ml, acc, args[4], max_slots=max_slots, split_slots=split)
    # the rows the merge kernel writes: live slots in more than one split
    ctx = args[4].long()
    multi = torch.where(ctx > 0, (ctx - 1) // split + 1, 0) > 1
    single = torch.tensor([True, True, False, True, False])  # ctx 32, 1, 64 fit in one split
    assert torch.equal(multi, ~single)
    out = torch.full_like(args[0], 7.0)
    out[multi] = merged[multi].to(out.dtype)
    assert torch.all(out[single] == 7.0)
    want = paged_decode_split_plain(*args, **kw, split_slots=split)
    assert torch.equal(out[~single], want[~single])
