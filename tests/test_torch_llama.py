"""The PyTorch port (transformers_tpu_torch) against the JAX package on a tiny
Llama: 2 layers, hidden 128, 4 query heads over 2 kv heads, head_dim 64.

Both packages compute from the same weights, made from a seed with numpy and
carried to the port by ``params_from_jax``, on the CPU in float32. head_dim
64 is one the kernels take, so the port routes exactly as it does on the
card: prefill through the flash kernel's wrapper and every decode step
through the fused decode wrapper, which on CPU tensors run their plain
versions; one variant uses head_dim 32 to hold the non-kernel routes too. The JAX package runs its eager path on the CPU (its flash kernel
is TPU-only, and its fused decode starts at batch 16).

Tolerances: logits agree below 2e-5 in float32 (the ROADMAP's parity bar;
the two frameworks sum in different orders). Logits are compared at valid
(non-pad) positions only: a left-pad query row sees no slot, and the port's
flash kernel gives such a row 0 where JAX's eager path averages V; pad rows
never reach a valid row, which the valid-position comparison shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu as ttpu
import transformers_tpu_torch as port
from transformers_tpu.generation import logits_process as jax_lp
from transformers_tpu_torch.core.safetensors import load_file, save_file
from transformers_tpu_torch.generation import logits_process as port_lp

TOL = 2e-5
BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            max_position_embeddings=128, rms_norm_eps=1e-5, eos_token_id=2, pad_token_id=0)
VARIANTS = {
    "base": {},
    "tied_llama3_rope": dict(tie_word_embeddings=True, rope_scaling={
        "rope_type": "llama3", "factor": 2.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 16}),
    "sliding_window": dict(sliding_window=5),
    # head_dim 32 is no kernel's: prefill takes the eager path and decode
    # the unfused one (rope, cache.update, cached_attention_bhsd)
    "unfused_head_dim32": dict(head_dim=32),
}


def _numpy_params(jax_model, seed):
    """Weights from a numpy seed in the JAX param layout: projections ~N(0, 0.1)
    (logits of std ~1, so greedy choices are not near-ties), norm scales
    around 1."""
    rng = np.random.default_rng(seed)
    spec = jax_model.init_abstract()

    def draw(path, s):
        if "norm" in jax.tree_util.keystr(path):
            return jnp.asarray(1.0 + 0.1 * rng.standard_normal(s.shape), jnp.float32)
        return jnp.asarray(0.1 * rng.standard_normal(s.shape), jnp.float32)

    return jax.tree_util.tree_map_with_path(draw, spec)


def _build(variant, seed=0):
    kw = dict(BASE, **VARIANTS[variant])
    jax_model = ttpu.LlamaForCausalLM(ttpu.LlamaConfig(**kw), dtype=jnp.float32)
    params = _numpy_params(jax_model, seed)
    model = port.LlamaForCausalLM(port.LlamaConfig(**kw), dtype=torch.float32, device="cpu")
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, params)), strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return jax_model, params, model


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return _build(request.param)


# a left-padded batch: row 0 has 3 pad slots
IDS = np.array([[0, 0, 0, 11, 7, 93, 4, 250, 31, 5],
                [17, 3, 64, 64, 9, 120, 2, 77, 8, 45]], np.int64)
MASK = np.array([[0, 0, 0, 1, 1, 1, 1, 1, 1, 1], [1] * 10], np.int32)
POS = np.maximum(np.cumsum(MASK, -1) - 1, 0)
VALID = MASK.astype(bool)


def jax_forward(jax_model):
    """``jax_model``'s forward compiled once per model, the JAX reference run
    as one XLA program instead of op by op: ``f(params, inputs, cache=None,
    slot=None)`` -> (logits, past_key_values); with a cache and no ``slot``, a
    static prefill at cache position 0."""
    fn = getattr(jax_model, "_test_forward", None)
    if fn is None:
        def forward(params, inputs, cache=None, slot=None):
            out = jax_model(params, **inputs, past_key_values=cache,
                            cache_position=0 if slot is None else slot)
            return out.logits, out.past_key_values

        fn = jax_model._test_forward = jax.jit(forward)
    return fn


def _close(port_logits, jax_logits, where=None):
    a = port_logits.detach().float().numpy()
    b = np.asarray(jax_logits, np.float32)
    if where is not None:
        a, b = a[where], b[where]
    err = float(np.abs(a - b).max())
    assert err < TOL, f"max |port - jax| = {err}"


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "left_padded"])
def test_forward_logits_match_jax(pair, padded):
    jax_model, params, model = pair
    if padded:
        kw = dict(input_ids=IDS, attention_mask=MASK, position_ids=POS)
        where = VALID
    else:
        kw = dict(input_ids=IDS[1:])
        where = None
    ref, _ = jax_forward(jax_model)(params, {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = model(**{k: torch.as_tensor(v) for k, v in kw.items()}).logits
    _close(out, ref, where)


def test_cached_prefill_and_decode_match_jax(pair):
    """Static prefill (flash path) then single-token steps (fused decode path)
    over a bhsd cache, against the JAX cached forward."""
    jax_model, params, model = pair
    b, s = IDS.shape
    total = s + 3
    mask = np.zeros((b, total), np.int32)
    mask[:, :s] = MASK
    jcache = jax_model.init_cache(b, total, dtype=jnp.float32)
    pcache = model.init_cache(b, total)
    forward = jax_forward(jax_model)
    ref, jcache = forward(params, dict(input_ids=jnp.asarray(IDS), attention_mask=jnp.asarray(mask),
                                       position_ids=jnp.asarray(POS)), jcache)
    with torch.no_grad():
        pout = model(input_ids=torch.as_tensor(IDS), attention_mask=torch.as_tensor(mask),
                     position_ids=torch.as_tensor(POS), past_key_values=pcache,
                     cache_position=0)
    _close(pout.logits, ref, VALID)
    tokens = np.array([[12], [200]], np.int64)
    for step in range(3):
        slot = s + step
        mask[:, slot] = 1
        pos = POS[:, -1:] + 1 + step
        ref, jcache = forward(params, dict(input_ids=jnp.asarray(tokens),
                                           attention_mask=jnp.asarray(mask),
                                           position_ids=jnp.asarray(pos)),
                              jcache, jnp.asarray(slot, jnp.int32))
        with torch.no_grad():
            pout = model(input_ids=torch.as_tensor(tokens), attention_mask=torch.as_tensor(mask),
                         position_ids=torch.as_tensor(pos), past_key_values=pcache,
                         cache_position=slot)
        _close(pout.logits, ref)
        tokens = (tokens * 7 + 3) % 256


@pytest.mark.parametrize("eos", [None, [200, 53, 255, 233]], ids=["config_eos", "eos_hit"])
def test_greedy_generate_matches_jax(pair, eos):
    """Two prompts of different lengths, left-padded, bucketed to 8: the port's
    tokens equal the JAX package's exactly. The config's EOS id (2) is never
    generated with these weights; the ``eos_hit`` ids are, in one row of each
    variant, which then finishes early and is padded."""
    jax_model, params, model = pair
    ids = np.array([[0, 0, 0, 5, 77, 140, 9, 33, 210, 6, 4],
                    [61, 18, 99, 250, 3, 3, 47, 128, 15, 90, 11]], np.int64)
    mask = (np.arange(11)[None, :] >= np.array([[3], [0]])).astype(np.int32)
    kw = dict(max_new_tokens=12, prompt_pad_multiple=8)
    if eos is not None:
        kw["eos_token_id"] = eos
    ref = np.asarray(jax_model.generate(params, input_ids=jnp.asarray(ids),
                                        attention_mask=jnp.asarray(mask), **kw))
    out = model.generate(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask), **kw)
    assert out.shape == ref.shape == (2, 16 + 12)
    np.testing.assert_array_equal(out.numpy(), ref)
    if eos is not None:
        assert np.isin(ref[:, 16:], eos).any(axis=1).sum() == 1


def test_checkpoint_round_trip(tmp_path):
    """JAX save_pretrained -> port from_pretrained gives the JAX logits, and the
    port's save_pretrained loads back in JAX with the same logits."""
    jax_model, params, _ = _build("base", seed=1)
    jax_model.params = params
    jax_model.save_pretrained(str(tmp_path / "from_jax"))
    model = port.AutoModelForCausalLM.from_pretrained(tmp_path / "from_jax", dtype="float32",
                                                      device="cpu")
    assert not model.load_report.missing_keys and not model.load_report.unexpected_keys
    ids = IDS[1:]
    ref = jax_model(params, input_ids=jnp.asarray(ids)).logits
    with torch.no_grad():
        _close(model(input_ids=torch.as_tensor(ids)).logits, ref)

    model.save_pretrained(tmp_path / "from_port")
    back = ttpu.AutoModelForCausalLM.from_pretrained(str(tmp_path / "from_port"),
                                                     dtype="float32")
    assert not back.load_report.missing_keys and not back.load_report.unexpected_keys
    _close(model(input_ids=torch.as_tensor(ids)).logits.detach(),
           back(back.params, input_ids=jnp.asarray(ids)).logits)


def test_bf16_checkpoint_loads_and_missing_keys_are_seeded(tmp_path):
    """bf16 tensors decode with torch dtypes; a key the checkpoint lacks is
    reported and initialised from the seed."""
    _, _, model = _build("base", seed=2)
    model.to(torch.bfloat16)
    model.save_pretrained(tmp_path / "bf16")
    sd = load_file(str(tmp_path / "bf16" / "model.safetensors"))
    assert sd["model.norm.weight"].dtype == torch.bfloat16
    del sd["lm_head.weight"]
    save_file(sd, str(tmp_path / "bf16" / "model.safetensors"))
    loaded = port.LlamaForCausalLM.from_pretrained(tmp_path / "bf16", dtype="bfloat16",
                                                   device="cpu", seed=3)
    assert loaded.load_report.missing_keys == ["lm_head.weight"]
    for name, p in loaded.named_parameters():
        if name != "lm_head.weight":
            assert torch.equal(p, model.get_parameter(name)), name
    assert float(loaded.lm_head.weight.detach().float().std()) == pytest.approx(0.02, rel=0.1)


PROCESSORS = {
    "temperature": (jax_lp.TemperatureLogitsWarper(0.7), port_lp.TemperatureLogitsWarper(0.7)),
    "top_k": (jax_lp.TopKLogitsWarper(5), port_lp.TopKLogitsWarper(5)),
    "top_p": (jax_lp.TopPLogitsWarper(0.8), port_lp.TopPLogitsWarper(0.8)),
}


@pytest.mark.parametrize("name", list(PROCESSORS))
def test_default_processors_match_jax(name):
    jproc, pproc = PROCESSORS[name]
    logits = np.random.default_rng(4).standard_normal((3, 64)).astype(np.float32) * 3
    ref = np.asarray(jproc(jnp.asarray(logits), {}))
    out = pproc(torch.as_tensor(logits), {}).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_sampled_generate_stays_in_top_k():
    """do_sample with top_k=1 is greedy whatever the draw; a seeded generator
    makes sampling repeatable."""
    _, _, model = _build("base", seed=5)
    ids = torch.as_tensor(IDS[1:])
    greedy = model.generate(ids, max_new_tokens=6, prompt_pad_multiple=1)
    top1 = model.generate(ids, max_new_tokens=6, prompt_pad_multiple=1, do_sample=True, top_k=1,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(greedy, top1)
    a, b = (model.generate(ids, max_new_tokens=6, prompt_pad_multiple=1, do_sample=True,
                           top_k=20, temperature=0.8, generator=torch.Generator().manual_seed(7))
            for _ in range(2))
    assert torch.equal(a, b)


def test_decode_steps_read_the_cache_slot_tensor(monkeypatch):
    """Every fused decode call of a generate gets the static cache's one slot
    tensor, holding that step's cache_position. The tensor is the decode
    loop's clock on the device: set once (one ``fill_``) before the first
    step, and advanced once per step (one ``add_(1)``), not once per layer."""
    from transformers_tpu_torch.models.llama import modeling_llama

    model = port.LlamaForCausalLM(port.LlamaConfig(**BASE), dtype=torch.float32,
                                  device="cpu").init_weights(3)
    calls, fills, adds = [], [], []
    real_decode, real_init = modeling_llama.fused_decode_attention, model.init_cache

    def init_cache(*args, **kw):
        cache = real_init(*args, **kw)
        real_fill, real_add = cache.slot.fill_, cache.slot.add_
        cache.slot.fill_ = lambda v: (fills.append(int(v)), real_fill(v))[1]
        cache.slot.add_ = lambda v: (adds.append(int(v)), real_add(v))[1]
        return cache

    def spy_decode(*args, **kw):
        calls.append((args[7], int(args[7])))  # the pos argument, and what it holds now
        return real_decode(*args, **kw)

    monkeypatch.setattr(model, "init_cache", init_cache)
    monkeypatch.setattr(modeling_llama, "fused_decode_attention", spy_decode)
    ids = torch.as_tensor(IDS[1:])
    model.generate(ids, max_new_tokens=5, prompt_pad_multiple=1)
    s, layers = ids.shape[1], BASE["num_hidden_layers"]
    assert [v for _, v in calls] == [s + g for g in range(4) for _ in range(layers)]
    assert all(t is calls[0][0] and t.dtype == torch.int32 and t.numel() == 1 for t, _ in calls)
    assert fills == [s]
    assert adds == [1] * 4


def test_cache_slot_tensor_is_range_checked():
    cache = port.cache_utils.init_static_cache(num_layers=1, batch_size=1, max_len=8,
                                               num_kv_heads=1, head_dim=64, dtype=torch.float32)
    assert int(cache.slot_tensor(7)) == 7
    with pytest.raises(ValueError, match="outside"):
        cache.slot_tensor(8)
