"""The port's continuous batching (CB) over paged KV, on the CPU.

A tiny Llama (2 layers, hidden 128, 4 query heads over 2 kv heads, head_dim
128, float32) with weights made from a numpy seed, carried to the port by
``params_from_jax``. At head_dim 128 the JAX runner takes its Pallas paged
decode route (interpret mode on the CPU) and the port takes the paged decode
kernel's wrapper, which runs its plain version on CPU tensors.

One test holds the port's ``generate_batch`` to the JAX package's: greedy
tokens exact. The rest hold the engine to the port's own static
``generate`` (greedy tokens exact) and to itself (multi-step == single-step,
sampling reproducible per request), mirroring
tests/generation/test_continuous_batching.py and test_cb_offloading.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu as ttpu
import transformers_tpu_torch as port
from transformers_tpu_torch.generation.continuous_batching import (
    BlockManager,
    ContinuousBatchingEngine,
    ContinuousBatchingManager,
    RequestState,
)
from transformers_tpu_torch.generation.continuous_batching.sampling import gumbel_noise
from transformers_tpu_torch.models.llama import modeling_llama
from transformers_tpu_torch.ops import attention
from torch_port_testing import one_torch_thread  # noqa: F401

CONFIG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=128,
              max_position_embeddings=128, rms_norm_eps=1e-5, eos_token_id=None,
              pad_token_id=0)
PROMPTS = [[1, 5, 9, 3], [7, 2, 8], [4, 4, 12, 19, 23, 6]]
ENGINE = dict(num_blocks=64, block_size=4, token_budget=4)


@pytest.fixture(scope="module")
def models():
    """(JAX model with params, port model) carrying the same weights:
    projections ~N(0, 0.1), norm scales around 1."""
    jax_model = ttpu.LlamaForCausalLM(ttpu.LlamaConfig(**CONFIG), dtype=jnp.float32)
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "norm" in jax.tree_util.keystr(path) else 0.0
        return jnp.asarray(base + 0.1 * rng.standard_normal(s.shape), jnp.float32)

    jax_model.params = jax.tree_util.tree_map_with_path(draw, jax_model.init_abstract())
    model = port.LlamaForCausalLM(port.LlamaConfig(**CONFIG), dtype=torch.float32, device="cpu")
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, jax_model.params)), strict=False)
    assert not missing and not unexpected
    return jax_model, model


@pytest.fixture(scope="module")
def model(models):
    return models[1]


def _static(model, prompt, max_new_tokens):
    """Greedy tokens of the port's static-cache generate, prompt alone."""
    out = model.generate(torch.tensor([prompt]), max_new_tokens=max_new_tokens,
                         prompt_pad_multiple=1)
    return out[0, len(prompt):].tolist()


def _run(model, prompts, budgets=None, steps=1, **req_kw):
    engine = ContinuousBatchingEngine(model, steps_per_sync=steps, **ENGINE)
    budgets = budgets or [6] * len(prompts)
    reqs = [RequestState(request_id=f"r{i}", prompt_ids=p, max_new_tokens=b, **req_kw)
            for i, (p, b) in enumerate(zip(prompts, budgets))]
    for r in reqs:
        engine.add_request(r)
    res = engine.run_to_completion()
    return [res[r.request_id].generated_ids for r in reqs]


# ---------------------------------------------------------------- unit tests
def test_block_manager_alloc_free():
    bm = BlockManager(num_blocks=8, block_size=4)
    assert bm.num_free_blocks == 7  # block 0 reserved
    blocks = bm.allocate(3)
    assert len(blocks) == 3 and 0 not in blocks
    assert bm.allocate(10) is None  # over-subscription defers
    bm.free(blocks)
    assert bm.num_free_blocks == 7


def test_block_manager_prefix_reuse():
    bm = BlockManager(num_blocks=16, block_size=4)
    ids = list(range(10))
    blocks = bm.allocate(3)
    bm.register_full_blocks(ids, blocks)  # 2 full blocks cached (8 tokens)
    shared, matched = bm.match_prefix(ids)
    assert matched == 8 and shared == blocks[:2]
    bm.free(blocks)  # the shared refs keep the blocks
    assert bm.ref_counts[blocks[0]] == 1
    bm.free(shared)
    assert blocks[0] not in bm.ref_counts


def test_gumbel_noise_is_a_function_of_seed_and_count():
    seed, count = torch.tensor([7, 7, 8]), torch.tensor([3, 4, 3])
    a, b = gumbel_noise(seed, count, 256), gumbel_noise(seed, count, 256)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert not torch.equal(a[0], a[1]) and not torch.equal(a[0], a[2])
    # Gumbel(0, 1): mean ~0.577 over the 768 draws
    assert abs(float(a.mean()) - 0.5772) < 0.15


# ------------------------------------------------------------------ e2e
def test_gathered_context_is_contiguous_at_one_page():
    """A prefill chunk's gathered k/v are contiguous for the flash kernel, a
    context of a single page included (reshaped alone, it would be a view
    with transposed head and slot strides)."""
    from transformers_tpu_torch.generation.continuous_batching.model_runner import PagedCacheView

    pools = [torch.randn(6, 2, 4, 8)]
    for tables in ([[3]], [[3, 1, 5]]):
        bt = torch.tensor(tables, dtype=torch.int32)
        view = PagedCacheView(pools, pools, bt, torch.zeros((1, 1), dtype=torch.int32),
                              torch.tensor([1], dtype=torch.int32), block_size=4)
        k, v = view.layer(0)
        assert k.is_contiguous() and v.is_contiguous()
        want = pools[0][bt[0].long()].transpose(1, 2).reshape(-1, 2, 8)
        assert torch.equal(k[0], want)


def test_generate_batch_matches_jax(models):
    """The port's CB greedy tokens equal the JAX package's CB tokens on ragged
    prompts (prefill-first scheduling: the JAX runner compiles one decode
    bucket). The port's decode-first schedule gives the same tokens."""
    jax_model, model = models
    kw = dict(max_new_tokens=6, num_blocks=32, block_size=16, token_budget=16)
    ref = jax_model.generate_batch(PROMPTS, scheduler="prefill_first", **kw)
    got = model.generate_batch(PROMPTS, scheduler="prefill_first", **kw)
    assert got == [list(map(int, r)) for r in ref]
    assert model.generate_batch(PROMPTS, **kw) == got


def test_cb_matches_static_generate(model):
    got = model.generate_batch(PROMPTS, max_new_tokens=6, **ENGINE)
    assert got == [_static(model, p, 6) for p in PROMPTS]


def test_decode_goes_through_the_paged_wrapper(model, monkeypatch):
    """Every decode step's attention takes the paged decode wrapper, once per
    layer, and every multi-token prefill chunk the flash wrapper."""
    calls = {"paged": 0, "flash": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(modeling_llama, "paged_decode_attention",
                        counted("paged", modeling_llama.paged_decode_attention))
    monkeypatch.setattr(attention, "flash_attention", counted("flash", attention.flash_attention))
    for steps in (1, 4):
        calls.update(paged=0, flash=0)
        engine = ContinuousBatchingEngine(model, steps_per_sync=steps, **ENGINE)
        for i, p in enumerate(PROMPTS + [[9]]):
            engine.add_request(RequestState(request_id=f"r{i}", prompt_ids=p, max_new_tokens=5))
        engine.run_to_completion()
        r = engine.runner
        assert r.decode_steps > 0 and r.prefill_chunks > 0 and r.single_token_chunks > 0
        assert calls == {"paged": 2 * (r.decode_steps + r.single_token_chunks),
                         "flash": 2 * r.prefill_chunks}


def test_cb_prefix_cache_reuse(model):
    """Two requests sharing a two-block prefix: the second reuses the cached
    blocks and still produces the static-generate tokens."""
    shared_prefix = [1, 5, 9, 3, 7, 2, 8, 4]  # 2 full blocks at block_size 4
    p1, p2 = shared_prefix + [11], shared_prefix + [13]
    engine = ContinuousBatchingEngine(model, **ENGINE)
    engine.add_request(RequestState(request_id="a", prompt_ids=p1, max_new_tokens=4))
    res1 = engine.run_to_completion()
    engine.add_request(RequestState(request_id="b", prompt_ids=p2, max_new_tokens=4))
    probe, matched = engine.bm.match_prefix(shared_prefix)
    assert matched == 8  # cache hit
    engine.bm.free(probe)  # undo the probe's refs
    before = engine.runner.prefill_tokens
    res2 = engine.run_to_completion()
    assert engine.runner.prefill_tokens - before == 1  # only the last token
    assert res1["a"].generated_ids == _static(model, p1, 4)
    assert res2["b"].generated_ids == _static(model, p2, 4)


def test_fully_cached_prompt_still_prefills_its_last_token(model):
    """A prompt whose every block is in the prefix cache completes."""
    prompt = [1, 5, 9, 3, 7, 2, 8, 4]
    engine = ContinuousBatchingEngine(model, **ENGINE)
    for rid in ("a", "b"):
        engine.add_request(RequestState(request_id=rid, prompt_ids=prompt, max_new_tokens=3))
        res = engine.run_to_completion()
        assert res[rid].generated_ids == _static(model, prompt, 3)


def test_cb_oversubscription_defers(model):
    """More requests than the pool can hold at once: all still complete."""
    prompts = [[i + 1, i + 2, i + 3] for i in range(6)]
    got = model.generate_batch(prompts, max_new_tokens=4, num_blocks=8, block_size=4,
                               token_budget=4)
    assert got == [_static(model, p, 4) for p in prompts]


def test_cb_scheduler_fairness_fifo(model):
    """FIFO: earlier-submitted requests finish no later than later ones."""
    engine = ContinuousBatchingEngine(model, num_blocks=16, block_size=4, token_budget=4,
                                      max_batch=2)
    for i in range(4):
        engine.add_request(RequestState(request_id=f"r{i}", prompt_ids=[i + 1, i + 2, i + 3],
                                        max_new_tokens=3))
    order = []
    while engine.has_work():
        order += [ev.request_id for ev in engine.step() if ev.status == "finished"]
    assert order == [f"r{i}" for i in range(4)]


# ------------------------------------------------- multi-step decode window
def test_cb_multistep_matches_single_step(model):
    single = model.generate_batch(PROMPTS, max_new_tokens=9, **ENGINE)
    multi = model.generate_batch(PROMPTS, max_new_tokens=9, steps_per_sync=4, **ENGINE)
    assert multi == single == [_static(model, p, 9) for p in PROMPTS]


def test_cb_multistep_crosses_block_boundary(model):
    """A window of 8 steps from a 3-token prompt writes into three blocks."""
    got = model.generate_batch([[1, 5, 9]], max_new_tokens=10, steps_per_sync=8, **ENGINE)
    assert got == [_static(model, [1, 5, 9], 10)]


def test_cb_multistep_eos_inside_window(model):
    """A row's EOS mid-window stops that row; the other continues."""
    base = _run(model, PROMPTS[:2], budgets=[8, 8])
    eos = base[0][2]
    got = _run(model, PROMPTS[:2], budgets=[8, 8], steps=4, eos_token_ids=(eos,))
    assert got == _run(model, PROMPTS[:2], budgets=[8, 8], eos_token_ids=(eos,))
    assert got[0] == base[0][:3]


def test_cb_multistep_mixed_budgets(model):
    budgets = [3, 7, 5]
    got = _run(model, PROMPTS, budgets=budgets, steps=4)
    assert got == _run(model, PROMPTS, budgets=budgets)
    assert [len(g) for g in got] == budgets


def test_cb_decode_bucket_boundaries(model):
    """The live batch crosses power-of-two buckets (3 -> 2 -> 1 rows) as
    requests finish, without drift."""
    budgets = [2, 5, 9]
    prompts = [[i + 1, i + 5, 9] for i in range(3)]
    got = _run(model, prompts, budgets=budgets)
    assert got == [_static(model, p, b) for p, b in zip(prompts, budgets)]


def test_cb_sampling_reproducible_per_request(model):
    """Temperature rows draw from (seed, tokens committed): a request's tokens
    do not depend on co-scheduled requests, and single-step == 4-step."""
    target = [1, 5, 9, 3]
    kw = dict(temperature=0.8, seed=7)
    runs = {(steps, crowded): _run(model, [target, [7, 2, 8]] if crowded else [target],
                                   steps=steps, **kw)[0]
            for steps in (1, 4) for crowded in (False, True)}
    assert len({tuple(v) for v in runs.values()}) == 1
    tokens = runs[(1, False)]
    assert len(tokens) == 6 and all(0 <= t < CONFIG["vocab_size"] for t in tokens)
    assert tokens != _static(model, target, 6)  # it did sample


def test_cb_top_k_routes_through_single_steps(model):
    """top-k rows take the single-step path (the device sampler filters);
    top_k=1 is greedy whatever the draw."""
    engine = ContinuousBatchingEngine(model, steps_per_sync=4, **ENGINE)
    engine.add_request(RequestState(request_id="r", prompt_ids=[1, 5, 9], max_new_tokens=4,
                                    temperature=0.7, top_k=1))
    res = engine.run_to_completion()
    assert res["r"].generated_ids == _static(model, [1, 5, 9], 4)


# ------------------------------------- preemption and the threaded manager
@pytest.mark.parametrize("swap_blocks,strategy", [(8, "swap"), (0, "reset")])
def test_cb_preemption_preserves_greedy_output(model, swap_blocks, strategy):
    """A pool that fits one request's context but not two forces preemption
    during chunked prefill; host swap and soft reset both keep the tokens."""
    prompts = [[3, 17, 9, 42, 7, 5], [11, 2, 19, 33]]
    engine = ContinuousBatchingEngine(model, num_blocks=9, block_size=4, token_budget=4,
                                      swap_blocks=swap_blocks)
    used = []
    offload = engine.offloader.offload
    engine.offloader.offload = lambda req, runner: used.append(offload(req, runner)) or used[-1]
    for i, p in enumerate(prompts):
        engine.add_request(RequestState(request_id=f"r{i}", prompt_ids=p, max_new_tokens=12))
    res = engine.run_to_completion()
    assert used and set(used) == {strategy}
    assert [res[f"r{i}"].generated_ids for i in range(2)] == [_static(model, p, 12)
                                                             for p in prompts]
    assert engine.offloader.offloaded == []


def test_cb_manager_threaded_with_cancel(model):
    manager = ContinuousBatchingManager(model, **ENGINE)
    manager.start()
    try:
        q1 = manager.submit(RequestState(request_id="x", prompt_ids=[1, 5, 9, 3],
                                         max_new_tokens=4))
        q2 = manager.submit(RequestState(request_id="y", prompt_ids=[7, 2, 8],
                                         max_new_tokens=100))
        manager.cancel("y")
        outs = {}
        for q in (q1, q2):
            while True:
                ev = q.get(timeout=60)
                if ev.status in ("finished", "failed", "cancelled"):
                    outs[ev.request_id] = ev
                    break
        assert outs["x"].status == "finished"
        assert outs["x"].generated_ids == _static(model, [1, 5, 9, 3], 4)
        assert outs["y"].status == "cancelled"
    finally:
        manager.stop()


def test_cb_failure_propagation(model):
    """An engine-step crash fails every queued request instead of hanging it."""
    manager = ContinuousBatchingManager(model, **ENGINE)
    manager.engine.runner.decode_step = None
    manager.engine.runner.prefill_chunk = None
    manager.start()
    try:
        q = manager.submit(RequestState(request_id="x", prompt_ids=[1, 5, 9], max_new_tokens=4))
        assert q.get(timeout=60).status == "failed"
        assert manager._error is not None
    finally:
        manager.stop()
