"""Weight-only quantization, the int8 KV cache and pre-quantized checkpoints of
the PyTorch port (transformers_tpu_torch) against the JAX package, on the CPU.

A seeded tiny Llama (2 layers, hidden 128, 4 query heads over 2 kv heads,
head_dim 64, float32; weights from a numpy seed, carried to the port by
``params_from_jax``) is quantized by both packages from the same float
weights. Held:

- int8 / int4 / fp8 codes and scales bitwise equal to the JAX quantizers'
  (the port keeps torch's [out, in] layout: int4 is the JAX packed tensor
  transposed), and ``params_from_jax`` carries the JAX quantized tree to the
  same tensors;
- ``quantized_dot`` and the port's ``quantized_linear`` (on CPU tensors the
  plain versions of both kernel routes) against the JAX ``quantized_dot`` to
  1e-5 (f32 sums in another order);
- quantized-model logits below 2e-5 and greedy ``generate`` ids equal for
  the three methods, and int8 continuous-batching ids equal to the JAX
  engine's;
- the int8 KV cache: per-step logits below 2e-5 and the same codes as the
  JAX package's (its ``generate`` route is held in test_torch_generation.py);
- each pre-quantized checkpoint reader bitwise equal to the JAX package's on
  the same seeded groups, and a GPTQ checkpoint written here loading in both
  packages to the same logits.

The JAX references run as the JAX package's own tests run them on the CPU.
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import transformers_tpu as ttpu
import transformers_tpu_torch as port
from transformers_tpu import quantizers as jq
from transformers_tpu.quantizers import checkpoint_formats as jcf
from transformers_tpu.quantizers import weight_only as jwo
from transformers_tpu_torch.cache_utils import QuantizedKVCache
from transformers_tpu_torch.ops import quantized_linear as pql
from transformers_tpu_torch.quantizers import checkpoint_formats as pcf
from transformers_tpu_torch.quantizers import weight_only as pwo

sys.path.insert(0, str(Path(__file__).resolve().parent / "quantization"))
sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_prequantized_checkpoints import (  # noqa: E402
    _gptq_quantize_tensor,
    pack_awq_scalar,
    pack_gptq_scalar,
)
from test_torch_llama import jax_forward  # noqa: E402

TOL = 2e-5
DOT_TOL = 1e-5
CONFIG = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
              num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              max_position_embeddings=128, rms_norm_eps=1e-5, eos_token_id=2, pad_token_id=0)
METHODS = {
    "int8": (jwo.Int8WeightOnlyConfig, port.Int8WeightOnlyConfig),
    "int4": (jwo.Int4WeightOnlyConfig, port.Int4WeightOnlyConfig),
    "fp8": (jwo.Fp8WeightOnlyConfig, port.Fp8WeightOnlyConfig),
}
# a left-padded batch: row 0 has 3 pad slots
IDS = np.array([[0, 0, 0, 11, 7, 93, 4, 250, 31, 5],
                [17, 3, 64, 64, 9, 120, 2, 77, 8, 45]], np.int64)
MASK = np.array([[0, 0, 0, 1, 1, 1, 1, 1, 1, 1], [1] * 10], np.int32)
POS = np.maximum(np.cumsum(MASK, -1) - 1, 0)
VALID = MASK.astype(bool)


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _close(port_logits, jax_logits, where=None, tol=TOL):
    a = port_logits.detach().float().numpy()
    b = np.asarray(jax_logits, np.float32)
    if where is not None:
        a, b = a[where], b[where]
    err = float(np.abs(a - b).max())
    assert err < tol, f"max |port - jax| = {err}"


@pytest.fixture(scope="module")
def base():
    """The JAX model, its float params (projections ~N(0, 0.1), norm scales
    around 1) and the port's float state dict of the same weights."""
    jax_model = ttpu.LlamaForCausalLM(ttpu.LlamaConfig(**CONFIG), dtype=jnp.float32)
    rng = np.random.default_rng(0)

    def draw(path, s):
        centre = 1.0 if "norm" in jax.tree_util.keystr(path) else 0.0
        return jnp.asarray(centre + 0.1 * rng.standard_normal(s.shape), jnp.float32)

    params = jax.tree_util.tree_map_with_path(draw, jax_model.init_abstract())
    return jax_model, params, port.params_from_jax(jax.tree.map(np.asarray, params))


def _port_model(state_dict, config=CONFIG):
    model = port.LlamaForCausalLM(port.LlamaConfig(**config), dtype=torch.float32, device="cpu")
    missing, unexpected = model.load_state_dict(state_dict, strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return model


@pytest.fixture(scope="module", params=list(METHODS))
def quantized(request, base):
    """(method, JAX model, JAX quantized params, port model quantized by the
    port from the same float weights)."""
    jax_model, params, state_dict = base
    jax_cfg, port_cfg = METHODS[request.param]
    qparams = jq.quantize_params(jax_model, jax.tree.map(lambda a: a, params), jax_cfg())
    model = port.quantize_params(_port_model(state_dict), port_cfg())
    return request.param, jax_model, qparams, model


# ------------------------------------------------------------ quantizers
def _weights(seed, shape=(96, 40)):
    """[in, out] float32 weights with the cases a quantizer must get right: a
    zero output column (scale floored at 1e-8) and values exactly halfway
    between two codes (round half to even)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0
    w[:, 5] = (np.arange(shape[0]) % 7 - 3.5).astype(np.float32)  # max 3.5 -> scale 3.5 / 127
    return w


@pytest.mark.parametrize("method", list(METHODS))
def test_codes_and_scales_bitwise_equal_jax(method):
    jax_cfg, port_cfg = METHODS[method]
    w = _weights(1)  # JAX layout [in, out]
    jcodes, jscale = jq.get_quantizer(jax_cfg()).quantize_tensor("w", jnp.asarray(w))
    pcodes, pscale = port.quantizers.get_quantizer(port_cfg()).quantize_tensor(
        "w", torch.from_numpy(w.T.copy()))
    jcodes = np.asarray(jcodes)
    want = (jcodes.view(np.uint8) if method == "fp8" else jcodes).T
    assert np.array_equal(_as_bits(pcodes).numpy(), want)
    assert np.array_equal(pscale.numpy(), np.asarray(jscale))
    # the JAX quantized tree carried by params_from_jax gives the same tensors
    state = port.params_from_jax({"proj": {"weight": jcodes, "weight_scale": np.asarray(jscale)}})
    assert state["proj.weight"].dtype == pcodes.dtype
    assert torch.equal(_as_bits(state["proj.weight"]), _as_bits(pcodes))
    assert torch.equal(state["proj.weight_scale"], pscale)
    if method == "int4":
        assert np.array_equal(pwo.unpack_int4_codes(pcodes).T.numpy(),
                              np.asarray(jwo.unpack_int4_codes(jcodes)))
        with pytest.raises(ValueError, match="even input dim"):
            port.quantizers.get_quantizer(port_cfg()).quantize_tensor(
                "odd", torch.ones(4, 7))


@pytest.mark.parametrize("rows", [3, 40], ids=["q1_rows", "q2_rows"])
@pytest.mark.parametrize("method", list(METHODS))
def test_quantized_dot_matches_jax(method, rows):
    """The plain product and the port's ``quantized_linear`` (3 rows take Q1's
    route, 40 take Q2's) against the JAX ``quantized_dot``."""
    jax_cfg, port_cfg = METHODS[method]
    w = _weights(2)
    x = np.random.default_rng(3).standard_normal((rows, w.shape[0])).astype(np.float32)
    jcodes, jscale = jq.get_quantizer(jax_cfg()).quantize_tensor("w", jnp.asarray(w))
    junpacked = jwo.unpack_int4_codes(jcodes) if method == "int4" else jcodes
    ref = np.asarray(jwo.quantized_dot(jnp.asarray(x), junpacked, jscale, jnp.float32))
    pcodes, pscale = port.quantizers.get_quantizer(port_cfg()).quantize_tensor(
        "w", torch.from_numpy(w.T.copy()))
    punpacked = pwo.unpack_int4_codes(pcodes) if method == "int4" else pcodes
    xt = torch.from_numpy(x)
    _close(pwo.quantized_dot(xt, punpacked, pscale, torch.float32), ref, tol=DOT_TOL)
    with torch.no_grad():
        _close(pql.quantized_linear(xt, pcodes, pscale, in_features=w.shape[0]), ref,
               tol=DOT_TOL)
    assert (rows <= pql.ROW_THRESHOLD) == (rows == 3)


# -------------------------------------------------------- quantized model
def test_quantized_model_matches_jax(quantized):
    """Codes equal JAX's, logits below 2e-5 at valid positions, greedy ids
    equal; a quantized Linear refuses gradients and dequantizes on request."""
    method, jax_model, qparams, model = quantized
    state = port.params_from_jax(jax.tree.map(np.asarray, qparams))
    ours = model.state_dict()
    assert set(state) == set(ours)
    for key, t in state.items():
        assert torch.equal(_as_bits(t), _as_bits(ours[key])), key
    kw = dict(input_ids=IDS, attention_mask=MASK, position_ids=POS)
    ref, _ = jax_forward(jax_model)(qparams, {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = model(**{k: torch.as_tensor(v) for k, v in kw.items()}).logits
    _close(out, ref, VALID)

    gkw = dict(max_new_tokens=8, prompt_pad_multiple=8)
    want = np.asarray(jax_model.generate(qparams, input_ids=jnp.asarray(IDS),
                                         attention_mask=jnp.asarray(MASK), **gkw))
    got = model.generate(torch.as_tensor(IDS), attention_mask=torch.as_tensor(MASK), **gkw)
    np.testing.assert_array_equal(got.numpy(), want)

    q_proj = model.model.layers[0].self_attn.q_proj
    dense = q_proj.materialize_weight()
    jdense = jax_model.model.layers[0].self_attn.q_proj.materialize_weight(
        qparams["model"]["layers"]["0"]["self_attn"]["q_proj"])
    np.testing.assert_array_equal(dense.numpy(), np.asarray(jdense).T)
    with pytest.raises(RuntimeError, match="no backward"):
        q_proj(torch.ones(1, CONFIG["hidden_size"], requires_grad=True))


def test_int8_continuous_batching_matches_jax(base):
    """int8 weights through the CB engine: greedy ids equal to the JAX
    engine's on ragged prompts."""
    jax_model, params, state_dict = base
    prompts = [[1, 5, 9, 3], [7, 2, 8], [4, 4, 12, 19, 23, 6]]
    jax_model.params = jq.quantize_params(jax_model, jax.tree.map(lambda a: a, params),
                                          jwo.Int8WeightOnlyConfig())
    model = port.quantize_params(_port_model(state_dict), port.Int8WeightOnlyConfig())
    kw = dict(max_new_tokens=6, num_blocks=32, block_size=16, token_budget=16)
    try:
        ref = jax_model.generate_batch(prompts, scheduler="prefill_first", **kw)
    finally:
        jax_model.params = None
    got = model.generate_batch(prompts, scheduler="prefill_first", **kw)
    assert got == [list(map(int, r)) for r in ref]


# ------------------------------------------------------- int8 KV cache
def test_quantized_cache_steps_match_jax(base):
    """The int8 KV cache (``init_cache(implementation="quantized")``): logits of
    a prefill and three decode steps (the slot as an int, then as the cache's
    slot tensor, as the decode loop passes it) below 2e-5 from the JAX
    package's, and the same codes at every valid slot. ``generate`` with
    ``cache_implementation="quantized"`` is held in test_torch_generation.py."""
    jax_model, params, state_dict = base
    model = _port_model(state_dict)
    b, s = IDS.shape
    total = s + 3
    mask = np.zeros((b, total), np.int32)
    mask[:, :s] = MASK
    jcache = jax_model.init_cache(b, total, dtype=jnp.float32, implementation="quantized")
    pcache = model.init_cache(b, total, implementation="quantized")
    assert isinstance(pcache, QuantizedKVCache) and pcache.keys[0].dtype == torch.int8
    forward = jax_forward(jax_model)
    logits, jcache = forward(params, dict(input_ids=jnp.asarray(IDS),
                                          attention_mask=jnp.asarray(mask),
                                          position_ids=jnp.asarray(POS)), jcache)
    with torch.no_grad():
        pout = model(input_ids=torch.as_tensor(IDS), attention_mask=torch.as_tensor(mask),
                     position_ids=torch.as_tensor(POS), past_key_values=pcache,
                     cache_position=0)
    _close(pout.logits, logits, VALID)
    tokens = np.array([[12], [200]], np.int64)
    for step in range(3):
        slot = s + step
        mask[:, slot] = 1
        pos = POS[:, -1:] + 1 + step
        logits, jcache = forward(params, dict(input_ids=jnp.asarray(tokens),
                                              attention_mask=jnp.asarray(mask),
                                              position_ids=jnp.asarray(pos)),
                                 jcache, jnp.asarray(slot, jnp.int32))
        cache_position = slot if step == 0 else pcache.slot_tensor(slot)
        with torch.no_grad():
            pout = model(input_ids=torch.as_tensor(tokens), attention_mask=torch.as_tensor(mask),
                         position_ids=torch.as_tensor(pos), past_key_values=pcache,
                         cache_position=cache_position)
        _close(pout.logits, logits)
        tokens = (tokens * 7 + 3) % 256
    # the caches hold the same codes at every valid slot, and scales (max |k| /
    # 127 of k computed in float32 in other orders) to a few ulps (a left-pad
    # query row sees no slot: the port's flash kernel gives it 0 where JAX's
    # eager path averages V, so from layer 1 on pad slots hold other values)
    live = np.broadcast_to(mask.astype(bool)[:, None, :], pcache.key_scales[0].shape[:3])
    for i in range(CONFIG["num_hidden_layers"]):
        for ours, theirs in ((pcache.keys[i], jcache.keys[i]), (pcache.values[i], jcache.values[i])):
            np.testing.assert_array_equal(ours.numpy()[live], np.asarray(theirs)[live])
        for ours, theirs in ((pcache.key_scales[i], jcache.key_scales[i]),
                             (pcache.value_scales[i], jcache.value_scales[i])):
            np.testing.assert_allclose(ours.numpy()[live], np.asarray(theirs)[live], rtol=1e-5,
                                       atol=0)


# ------------------------------------------------ pre-quantized checkpoints
def _reader_groups(rng):
    """One seeded group per reader, as (reader name, group, config)."""
    K, N, gs = 32, 16, 8
    q = rng.integers(0, 16, size=(K, N))
    z = rng.integers(0, 15, size=(K // gs, N))
    s = rng.normal(scale=0.1, size=(K // gs, N)).astype(np.float16)
    qweight, qzeros, scales = pack_gptq_scalar(q, z, s)
    gptq = {"qweight": qweight, "qzeros": qzeros, "scales": scales,
            "g_idx": rng.permutation(np.arange(K) // gs).astype(np.int32)}
    awq = {"qweight": pack_awq_scalar(q), "qzeros": pack_awq_scalar(z),
           "scales": s}
    vals = rng.integers(-8, 8, size=(N, K))
    packed = np.zeros((N, K // 8), np.uint32)
    for k in range(K):
        packed[:, k // 8] |= (vals[:, k] & 0xF).astype(np.uint32) << ((k % 8) * 4)
    compressed = {"weight_packed": packed.view(np.int32),
                  "weight_scale": rng.normal(size=(N, K // gs)).astype(np.float16),
                  "weight_shape": np.array([N, K], np.int64)}
    fp8_w = rng.normal(size=(N, K)).astype(ml_dtypes.float8_e4m3fn)
    numel = N * K
    bnb4 = {"weight": rng.integers(0, 256, size=(numel // 2, 1)).astype(np.uint8),
            "absmax": rng.random(numel // 64).astype(np.float32),
            "quant_state.bitsandbytes__nf4": np.frombuffer(json.dumps(
                {"shape": [N, K], "blocksize": 64}).encode(), np.uint8).copy()}
    bnb8 = {"weight": rng.integers(-127, 128, size=(N, K)).astype(np.int8),
            "SCB": rng.random(N).astype(np.float32)}
    hqq = {"W_q": rng.integers(0, 256, size=(numel // 16, 8)).astype(np.uint8),
           "scale": rng.random((numel // 8, 1)).astype(np.float32),
           "zero": rng.random((numel // 8, 1)).astype(np.float32),
           "meta": np.frombuffer(json.dumps({"nbits": 4, "shape": [N, K], "axis": 1,
                                             "group_size": 8}).encode(), np.uint8).copy()}
    bitnet = {"weight": rng.integers(0, 256, size=(N // 4, K)).astype(np.uint8),
              "weight_scale": np.array([0.37], np.float32)}
    return [
        ("dequant_gptq", gptq, {"bits": 4, "group_size": gs}),
        ("dequant_awq", awq, {"bits": 4, "group_size": gs}),
        ("dequant_compressed_int", compressed, {"num_bits": 4}),
        ("dequant_fp8", {"weight": fp8_w, "weight_scale": rng.random(N).astype(np.float32)}, {}),
        ("dequant_fp8", {"weight": fp8_w,
                         "weight_scale_inv": rng.random((2, 4)).astype(np.float32)},
         {"weight_block_size": [8, 8]}),
        ("dequant_bnb_4bit", bnb4, {}),
        ("dequant_bnb_8bit", bnb8, {}),
        ("dequant_hqq", hqq, {}),
        ("dequant_bitnet", bitnet, {}),
    ]


READERS = ["gptq", "awq", "compressed", "fp8_channel", "fp8_block", "bnb4", "bnb8", "hqq",
           "bitnet"]


@pytest.mark.parametrize("case", range(len(READERS)), ids=READERS)
def test_checkpoint_reader_bitwise_equal_jax(case):
    name, group, qcfg = _reader_groups(np.random.default_rng(11))[case]
    want = getattr(jcf, name)(group, qcfg)
    got = getattr(pcf, name)(group, qcfg)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_dequantize_state_dict_matches_jax():
    """A whole GPTQ state dict through both packages' ``dequantize_state_dict``,
    and an fp8 one given to the port as torch tensors (its reader's form)."""
    rng = np.random.default_rng(12)
    _, gptq, qcfg = _reader_groups(rng)[0]
    tensors = {f"layer.{k}": v for k, v in gptq.items()}
    tensors["norm.weight"] = rng.random(16).astype(np.float32)
    qdict = {"quant_method": "gptq", **qcfg}
    want = jcf.dequantize_state_dict(tensors, qdict)
    got = pcf.dequantize_state_dict(tensors, qdict)
    assert sorted(got) == sorted(want) == ["layer.weight", "norm.weight"]
    for k in want:
        assert np.array_equal(got[k], want[k])
    fp8 = {"p.weight": rng.normal(size=(8, 16)).astype(ml_dtypes.float8_e4m3fn),
           "p.weight_scale": np.float32([0.5])}
    want = jcf.dequantize_state_dict(fp8, {"quant_method": "fp8"})
    as_torch = {"p.weight": torch.from_numpy(fp8["p.weight"].view(np.uint8)).view(
        torch.float8_e4m3fn), "p.weight_scale": torch.from_numpy(fp8["p.weight_scale"])}
    got = pcf.dequantize_state_dict(as_torch, {"quant_method": "fp8"})
    assert np.array_equal(got["p.weight"], want["p.weight"])


def test_gptq_checkpoint_loads_in_both_packages(base, tmp_path):
    """A GPTQ checkpoint of the tiny Llama, written here, loads through both
    packages' ``from_pretrained`` to logits below 2e-5."""
    _, _, state_dict = base
    out = {}
    for key, t in state_dict.items():
        if key.endswith("_proj.weight"):
            qweight, qzeros, scales, _ = _gptq_quantize_tensor(t.numpy())
            prefix = key[:-len(".weight")]
            out.update({f"{prefix}.qweight": qweight, f"{prefix}.qzeros": qzeros,
                        f"{prefix}.scales": scales,
                        f"{prefix}.g_idx": (np.arange(t.shape[1]) // 8).astype(np.int32)})
        else:
            out[key] = t.numpy()
    from transformers_tpu.core.safetensors import save_file

    save_file(out, str(tmp_path / "model.safetensors"))
    cfg = dict(CONFIG, model_type="llama", architectures=["LlamaForCausalLM"],
               quantization_config={"quant_method": "gptq", "bits": 4, "group_size": 8,
                                    "desc_act": False})
    (tmp_path / "config.json").write_text(json.dumps(cfg))
    jm = ttpu.AutoModelForCausalLM.from_pretrained(str(tmp_path), dtype="float32")
    pm = port.AutoModelForCausalLM.from_pretrained(tmp_path, dtype="float32", device="cpu")
    assert not pm.load_report.missing_keys and not pm.load_report.unexpected_keys
    ref, _ = jax_forward(jm)(jm.params, dict(input_ids=jnp.asarray(IDS[1:])))
    with torch.no_grad():
        got = pm(torch.as_tensor(IDS[1:])).logits
    _close(got, ref)


def test_outgrown_widen_buffer_stays_allocated(monkeypatch):
    """Q2's buffer grows at a call outside graph capture and keeps the one it
    outgrew, which a graph captured earlier still replays into; it refuses
    to grow inside a capture. (The buffer serves CUDA tensors only; here the
    capture state is set by hand and the buffers live on the CPU.)"""
    monkeypatch.setattr(pql, "_WIDE", {})
    monkeypatch.setattr(pql, "_RETIRED", [])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    cpu = torch.device("cpu")
    first = pql._wide_buffer(cpu, torch.bfloat16, 64)
    assert pql._wide_buffer(cpu, torch.bfloat16, 32) is first
    grown = pql._wide_buffer(cpu, torch.bfloat16, 128)
    assert grown.numel() == 128 and pql._RETIRED == [first]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    assert pql._wide_buffer(cpu, torch.bfloat16, 100) is grown
    with pytest.raises(RuntimeError, match="outside CUDA graph capture"):
        pql._wide_buffer(cpu, torch.bfloat16, 256)


def test_checkpoint_source_refuses_other_entries():
    from transformers_tpu_torch.core.loading import DictSource, open_checkpoint_source

    assert isinstance(open_checkpoint_source({"w": np.zeros(2)}), DictSource)
    with pytest.raises(TypeError, match="file path or a state dict"):
        open_checkpoint_source(object())
