"""The port's DeepSeek tree against the JAX package's, on the CPU, float32:
DeepSeek-V3, DeepSeek-V2 and Mistral4 (multi-head latent attention, MLA)
and the families on DeepSeek-V3's MoE block, GLM-4.5 MoE, dots.llm1 and
Solar-Open.

Each family is the JAX package's own test config (``tests/models/
test_decoder_families.py``: ``deepseek_v2``, ``deepseek_v2-group``,
``dots1``, ``deepseek_v3``, ``deepseek_v3-noqlora``, ``glm4_moe``,
``glm4_moe-qknorm``; ``test_r3_decoders.py``: ``solar_open``) cut to 2
layers with a vocabulary of 256, plus a Mistral4 of the same size with no
shared experts and an attention temperature whose period (4 slots) the
prompts pass. Weights come from a numpy seed, every leaf drawn (the
correction biases too), and are carried by ``params_from_jax``.

Per family: logits of a left-padded batch within 2e-5 of JAX's at valid
positions and greedy static ``generate`` tokens equal to JAX's greedy
choices, under both expert routes (JAX's reference on its default route);
the configs' defaults attribute by attribute; a ``save_pretrained`` ->
``from_pretrained`` round trip that writes the JAX writer's keys and
tensors (the routers in the hub's ``[E, H]``, the correction biases, one
tensor per expert). For the MLA families: cached decode equal to the full
forward, the latent cache's shapes and its refusal of ``"quantized"``, and
the continuous-batching engine's refusal (the JAX engine fails at its first
cache write). The routers in their blocks against JAX's with planted ties
(equal gate rows, so equal scores for every token): DeepSeek-V3's groups,
DeepSeek-V2's ``greedy`` and ``group_limited_greedy``, Mistral4's softmax
groups. The two MLA ropes and ``yarn_mscale_factor`` against JAX's
functions. Continuous batching for GLM-4.5 (K6's route, partial rotary)
equals static ``generate``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu_torch as port
from transformers_tpu.models.deepseek_v2 import DeepseekV2Config, DeepseekV2ForCausalLM
from transformers_tpu.models.deepseek_v2 import modeling_deepseek_v2 as jax_v2
from transformers_tpu.models.deepseek_v3 import DeepseekV3Config, DeepseekV3ForCausalLM
from transformers_tpu.models.deepseek_v3 import modeling_deepseek_v3 as jax_v3
from transformers_tpu.models.dots1 import Dots1Config, Dots1ForCausalLM
from transformers_tpu.models.glm4_moe import Glm4MoeConfig, Glm4MoeForCausalLM
from transformers_tpu.models.mistral4 import Mistral4Config, Mistral4ForCausalLM
from transformers_tpu.models.mistral4.modeling_mistral4 import Mistral4MoE
from transformers_tpu.models.solar_open import SolarOpenConfig, SolarOpenForCausalLM
from transformers_tpu_torch.core.safetensors import load_file
from transformers_tpu_torch.models.deepseek_v2 import modeling_deepseek_v2 as port_v2
from transformers_tpu_torch.models.deepseek_v3 import modeling_deepseek_v3 as port_v3
from transformers_tpu_torch.models.mistral4 import modeling_mistral4 as port_mistral4
from transformers_tpu_torch.ops import rope as port_rope
from test_torch_families import GEN_IDS, GEN_MASK
from test_torch_llama import TOL, _numpy_params, jax_forward
from torch_port_testing import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=256, pad_token_id=0,
            bos_token_id=1, eos_token_id=2)
MLA = dict(num_key_value_heads=4, kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=8,
           v_head_dim=8, moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
           first_k_dense_replace=1)
GLM = dict(num_key_value_heads=2, head_dim=8, n_routed_experts=4, num_experts_per_tok=2,
           moe_intermediate_size=32, n_shared_experts=1, first_k_dense_replace=1)
FAMILIES = {  # case: (model_type, JAX config class, JAX model class, config)
    "deepseek_v3": ("deepseek_v3", DeepseekV3Config, DeepseekV3ForCausalLM, dict(
        MLA, q_lora_rank=16, n_group=4, topk_group=2, n_shared_experts=1, norm_topk_prob=True,
        routed_scaling_factor=2.5)),
    "deepseek_v3-noqlora": ("deepseek_v3", DeepseekV3Config, DeepseekV3ForCausalLM, dict(
        MLA, q_lora_rank=None, n_group=4, topk_group=2, n_shared_experts=1,
        norm_topk_prob=True, rope_interleave=False)),
    "deepseek_v2": ("deepseek_v2", DeepseekV2Config, DeepseekV2ForCausalLM, dict(
        MLA, q_lora_rank=24, n_shared_experts=1, routed_scaling_factor=1.0,
        topk_method="greedy")),
    "deepseek_v2-group": ("deepseek_v2", DeepseekV2Config, DeepseekV2ForCausalLM, dict(
        MLA, q_lora_rank=None, n_shared_experts=1, routed_scaling_factor=2.0,
        topk_method="group_limited_greedy", n_group=2, topk_group=1)),
    "mistral4": ("mistral4", Mistral4Config, Mistral4ForCausalLM, dict(
        MLA, q_lora_rank=16, n_group=4, topk_group=2, n_shared_experts=None,
        routed_scaling_factor=1.5, llama_4_scaling_beta=0.1, original_max_position_embeddings=4)),
    "glm4_moe": ("glm4_moe", Glm4MoeConfig, Glm4MoeForCausalLM, dict(GLM, attention_bias=True)),
    "glm4_moe-qknorm": ("glm4_moe", Glm4MoeConfig, Glm4MoeForCausalLM, dict(
        GLM, use_qk_norm=True)),
    "dots1": ("dots1", Dots1Config, Dots1ForCausalLM, dict(
        num_key_value_heads=2, head_dim=8, moe_intermediate_size=32, n_routed_experts=8,
        n_shared_experts=1, n_group=2, topk_group=1, num_experts_per_tok=2,
        first_k_dense_replace=1, norm_topk_prob=True, routed_scaling_factor=1.5,
        sliding_window=None)),
    "solar_open": ("solar_open", SolarOpenConfig, SolarOpenForCausalLM, dict(
        num_key_value_heads=2, head_dim=8, moe_intermediate_size=32, n_routed_experts=4,
        num_experts_per_tok=2, n_group=1, topk_group=1, n_shared_experts=1)),
}
MLA_CASES = ("deepseek_v3", "deepseek_v2", "mistral4")
ROUTES = ("dense", "ragged")
CASES = [(family, route) for family in FAMILIES for route in ROUTES]


def _config(case):
    return dict(TINY, **FAMILIES[case][3])


def _build(case):
    """(case, JAX model, its params, the port's model with the same weights),
    float32, the port's on the CPU."""
    model_type, jax_cfg_cls, jax_cls, _ = FAMILIES[case]
    config = _config(case)
    jax_model = jax_cls(jax_cfg_cls(**config), dtype=jnp.float32)
    params = _numpy_params(jax_model, 60 + len(case))
    if config.get("n_shared_experts", 1) is None:
        # the JAX block deletes its shared experts but keeps their params,
        # which no call reads; the port has none
        for layer in params["model"]["layers"].values():
            layer["mlp"].pop("shared_experts", None)
    model = port.AutoModelForCausalLM.from_config(
        port.AutoConfig.for_model_type(model_type, **config), dtype=torch.float32, device="cpu")
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, params), model_type), strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return case, jax_model, params, model


@pytest.fixture(scope="module")
def built():
    """The cases built so far, kept for the module: pytest sets the
    parametrised ``family`` fixture up again as it reorders the tests, and
    each JAX model keeps its compiled forward."""
    return {}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request, built):
    if request.param not in built:
        built[request.param] = _build(request.param)
    return built[request.param]


@pytest.fixture
def routed(request, family):
    """The family's fixture with the port's ``experts_implementation`` set to
    the case's route, restored after the test."""
    model = family[3]
    before = getattr(model.config, "experts_implementation", None)
    model.config.experts_implementation = request.param
    yield family
    model.config.experts_implementation = before


def _cases():
    return pytest.mark.parametrize("family,routed", CASES, indirect=True,
                                   ids=[f"{f}-{r}" for f, r in CASES])


def test_family_config_defaults_are_jax(family):
    """The port's config class, with no argument, has every attribute of the
    JAX config's defaults at the same value; the model's class is JAX's."""
    case, jax_model, _, model = family
    assert type(model).__name__ == type(jax_model).__name__
    model_type, jax_cfg_cls = FAMILIES[case][:2]
    defaults, jax_defaults = port.AutoConfig.for_model_type(model_type), jax_cfg_cls()
    for key, value in vars(jax_defaults).items():
        if not key.startswith("_") and key not in ("architectures", "dtype"):
            assert getattr(defaults, key) == value, key


NEW = 6
# GEN_IDS (rows left-padded by 3 and 0) with NEW more slots: the logits test
# fills them, the greedy reference grows into them; one shape, one JAX compile
SEQ_IDS = np.concatenate([GEN_IDS, [[17, 230, 4, 61, 88, 9], [120, 7, 199, 3, 54, 31]]], 1)
SEQ_MASK = np.concatenate([GEN_MASK, np.ones((2, NEW), np.int32)], 1)


def _positions(mask):
    return np.maximum(np.cumsum(mask, -1) - 1, 0)


def _port_logits(model, ids=SEQ_IDS, mask=SEQ_MASK):
    with torch.no_grad():
        return model(torch.as_tensor(ids), attention_mask=torch.as_tensor(mask),
                     position_ids=torch.as_tensor(_positions(mask))).logits


@_cases()
def test_family_logits_match_jax(routed):
    _, jax_model, params, model = routed
    kw = dict(input_ids=SEQ_IDS, attention_mask=SEQ_MASK, position_ids=_positions(SEQ_MASK))
    ref, _ = jax_forward(jax_model)(params, {k: jnp.asarray(v) for k, v in kw.items()})
    valid = SEQ_MASK.astype(bool)
    err = float(np.abs(_port_logits(model).numpy()[valid]
                       - np.asarray(ref, np.float32)[valid]).max())
    assert err < TOL, f"max |port - jax| = {err}"


def _jax_greedy(jax_model, params):
    """The JAX model's greedy tokens for GEN_IDS: NEW steps of its forward
    over the whole sequence so far (causal, so the slots not yet filled are
    never seen), a row that drew an EOS padded after it, as ``generate`` pads
    it."""
    ids = getattr(jax_model, "_test_greedy", None)
    if ids is None:
        seq, mask = SEQ_IDS.copy(), np.concatenate([GEN_MASK, np.zeros((2, NEW), np.int32)], 1)
        finished = np.zeros(2, bool)
        eos, pad = jax_model.config.eos_token_id, jax_model.config.pad_token_id
        for t in range(GEN_IDS.shape[1], seq.shape[1]):
            kw = dict(input_ids=seq, attention_mask=mask, position_ids=_positions(mask))
            logits, _ = jax_forward(jax_model)(params, {k: jnp.asarray(v) for k, v in kw.items()})
            tok = np.where(finished, pad, np.asarray(logits)[:, t - 1].argmax(-1))
            seq[:, t], mask[:, t] = tok, 1
            finished |= tok == eos
        ids = jax_model._test_greedy = seq[:, GEN_IDS.shape[1]:]
    return ids


@_cases()
def test_family_greedy_generate_matches_jax(routed):
    """Left-padded prompts bucketed to 16 slots, NEW new tokens through the
    static cache (the MLA families' latent cache re-expanded every step)."""
    _, jax_model, params, model = routed
    out = model.generate(torch.as_tensor(GEN_IDS), attention_mask=torch.as_tensor(GEN_MASK),
                         max_new_tokens=NEW, prompt_pad_multiple=8)
    np.testing.assert_array_equal(out[:, -NEW:].numpy(), _jax_greedy(jax_model, params))


@pytest.mark.parametrize("family", MLA_CASES, indirect=True)
def test_mla_cached_decode_matches_full_forward(family):
    """A prefill of the left-padded prompts into the latent cache, then the
    next NEW tokens one at a time through it (each step re-expands the whole
    history): every step's logits equal the full forward's at that position
    within 2e-5. The cache holds the latents [B, 1, S, kv_lora_rank] and the
    rotated shared key [B, 1, S, qk_rope_head_dim]; it refuses "quantized"."""
    case, _, _, model = family
    cfg = model.config
    total = SEQ_IDS.shape[1]
    cache = model.init_cache(2, total)
    assert len(cache.keys) == len(cache.values) == cfg.num_hidden_layers
    assert cache.keys[0].shape == (2, 1, total, cfg.kv_lora_rank)
    assert cache.values[0].shape == (2, 1, total, cfg.qk_rope_head_dim)
    with pytest.raises(ValueError, match="quantized"):
        model.init_cache(2, total, implementation="quantized")
    with pytest.raises(ValueError, match="quantized"):
        model.generate(torch.as_tensor(GEN_IDS), attention_mask=torch.as_tensor(GEN_MASK),
                       max_new_tokens=2, cache_implementation="quantized")
    full = _port_logits(model)
    ids, mask, pos = (torch.as_tensor(a) for a in (SEQ_IDS, SEQ_MASK, _positions(SEQ_MASK)))
    kv_mask = torch.zeros_like(mask)
    p = GEN_IDS.shape[1]
    kv_mask[:, :p] = mask[:, :p]
    with torch.no_grad():
        steps = [model(ids[:, :p], attention_mask=kv_mask, position_ids=pos[:, :p],
                       past_key_values=cache, cache_position=0).logits[:, -1]]
        for t in range(p, total - 1):
            kv_mask[:, t] = 1
            steps.append(model(ids[:, t:t + 1], attention_mask=kv_mask,
                               position_ids=pos[:, t:t + 1], past_key_values=cache,
                               cache_position=t).logits[:, -1])
    err = float((torch.stack(steps, 1) - full[:, p - 1:total - 1]).abs().max())
    assert err < TOL, f"{case}: max |cached - full| = {err}"


def test_mla_continuous_batching_is_refused(family_v3):
    """The engine refuses an MLA model at construction, saying why: its pools
    hold per-head keys and values, and the latent cache is neither (the JAX
    engine takes the model and fails at its first cache write)."""
    from transformers_tpu_torch.generation.continuous_batching import ContinuousBatchingEngine

    with pytest.raises(NotImplementedError, match="latent"):
        ContinuousBatchingEngine(family_v3, num_blocks=8, block_size=4)
    with pytest.raises(NotImplementedError, match="latent"):
        family_v3.generate_batch([[5, 7, 9]], max_new_tokens=2, num_blocks=8, block_size=4)


@pytest.fixture(scope="module")
def family_v3():
    return port.AutoModelForCausalLM.from_config(
        port.AutoConfig.for_model_type("deepseek_v3", **_config("deepseek_v3")),
        dtype=torch.float32, device="cpu").init_weights(3)


@pytest.mark.parametrize("family", ["glm4_moe"], indirect=True)
def test_glm4_moe_continuous_batching_matches_static_generate(family):
    """Prompts of 3-12 tokens through the paged engine (4-token prefill chunks
    over pages of 4, the ragged route) give the static generate's greedy
    tokens: GLM-4.5's decode on K6's route with half of each head rotated."""
    model = family[3]
    model.config.experts_implementation = "ragged"
    eos = model.config.eos_token_id
    prompts = [[5, 77, 140, 9, 33, 210, 6, 4, 19, 3, 200, 8], [61, 18, 99], [7, 2, 8, 45, 90, 11]]
    try:
        got = model.generate_batch(prompts, max_new_tokens=6, num_blocks=32, block_size=4,
                                   token_budget=4)
        for prompt, tokens in zip(prompts, got):
            out = model.generate(torch.tensor([prompt]), max_new_tokens=6, prompt_pad_multiple=1)
            want = out[0, len(prompt):].tolist()
            if eos in want:
                want = want[:want.index(eos) + 1]
            assert tokens == want
    finally:
        model.config.experts_implementation = None


@pytest.mark.parametrize("case", ["interleave", "complex_pairs", "yarn_mscale"])
def test_mla_rope_matches_jax(case):
    """DeepSeek-V3's rope (interleaved pairs into halves) and V2's (pairs kept)
    on q [B, S, H, 8] and the shared key against JAX's functions within 1e-6,
    over Llama-layout tables of yarn frequencies; ``yarn_mscale_factor``
    against JAX's for yarn with and without ``mscale_all_dim``, a factor of
    1 and no scaling."""
    if case == "yarn_mscale":
        for scaling in (None, {"rope_type": "yarn", "factor": 40.0, "mscale_all_dim": 0.707},
                        {"type": "yarn", "factor": 40.0, "mscale": 0.707},
                        {"type": "yarn", "factor": 1.0, "mscale_all_dim": 1.0},
                        {"rope_type": "yarn", "factor": 4.0, "mscale_all_dim": 1.0}):
            cfg = DeepseekV3Config(rope_scaling=scaling)
            assert port_rope.yarn_mscale_factor(cfg) == jax_v3.yarn_mscale_factor(cfg), scaling
        assert port_rope.yarn_mscale_factor(DeepseekV3Config(
            rope_scaling={"rope_type": "yarn", "factor": 4.0, "mscale_all_dim": 1.0})) > 1.0
        return
    rng = np.random.default_rng(7)
    cfg = port.DeepseekV2Config(qk_rope_head_dim=8, rope_scaling={
        "type": "yarn", "factor": 40.0, "original_max_position_embeddings": 64,
        "mscale": 0.707, "mscale_all_dim": 0.707})
    inv, scaling = port_rope.rope_inv_freq(cfg)
    pos = rng.integers(0, 300, size=(2, 5))
    cos, sin = port_rope.compute_cos_sin(torch.as_tensor(pos), inv, scaling)
    q = rng.standard_normal((2, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 5, 1, 8)).astype(np.float32)
    port_fn, jax_fn = {"interleave": (port_rope.apply_rope_interleave_deepseek,
                                      jax_v3.apply_rope_interleave_deepseek),
                       "complex_pairs": (port_rope.apply_rope_complex_pairs,
                                         jax_v2.apply_rope_complex_pairs)}[case]
    for x in (q, k):
        want = np.asarray(jax_fn(jnp.asarray(x), jnp.asarray(cos.numpy()),
                                 jnp.asarray(sin.numpy())))
        got = port_fn(torch.from_numpy(x), cos, sin).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


ROUTER_CASES = ["deepseek_v3", "deepseek_v2", "deepseek_v2-group", "mistral4"]


def _router_block(case):
    """(JAX MoE block, its params, the port's block with the same weights):
    8 experts in 4 groups (V2's case 2), every gate row equal, so every
    expert's score ties for every token; V3's correction bias is 0 on the
    first half of the experts and -1 on the rest, which it keeps from the
    choice."""
    rng = np.random.default_rng(31)
    model_type, jax_cfg_cls = FAMILIES[case][:2]
    config = dict(_config(case), topk_group=2, n_group=4)
    if case == "deepseek_v2-group":
        config.update(n_group=2, topk_group=1)
    jax_block_cls = {"deepseek_v3": jax_v3.DeepseekV3MoE, "mistral4": Mistral4MoE}.get(
        model_type, jax_v2.DeepseekV2Moe)
    jax_block = jax_block_cls(jax_cfg_cls(**config), dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.tree.map(lambda s: jnp.asarray(0.3 * rng.standard_normal(s.shape), jnp.float32),
                          jax_block.init_abstract())
    if config["n_shared_experts"] is None:
        params.pop("shared_experts")  # kept by the JAX block, read by no call
    row = rng.standard_normal(32).astype(np.float32)
    gate = params["gate"]
    tied = np.tile(row, (8, 1))  # [E, H]
    gate["weight"] = jnp.asarray(tied if model_type == "deepseek_v2" else tied.T)
    if "e_score_correction_bias" in gate:
        gate["e_score_correction_bias"] = jnp.asarray(np.repeat([0.0, -1.0], 4), jnp.float32)
    block_cls = {"deepseek_v3": port_v3.DeepseekV3MoE, "deepseek_v2": port_v2.DeepseekV2Moe,
                 "mistral4": port_mistral4.Mistral4MoE}[model_type]
    block = block_cls(port.AutoConfig.for_model_type(model_type, **config), dtype=torch.float32,
                      param_dtype=torch.float32, device="cpu")
    block.load_state_dict(port.params_from_jax(jax.tree.map(np.asarray, params), model_type))
    return jax_block, params, block


@pytest.mark.parametrize("case", ROUTER_CASES)
def test_router_with_planted_ties_matches_jax(case):
    """Every expert's score ties for every token, so the groups' ranks tie
    too: the lower group and the lower expert win each tie, as in JAX
    (experts 0 and 1 for all 6 tokens: V3's bias keeps experts 4-7 out; V2's
    ``greedy`` takes them from all experts, its groups and Mistral4's from
    the first groups), and the block's output equals the JAX block's within
    2e-5. V3's weights are the unbiased scores renormalized, times 2.5;
    V2's the softmax scores (1/8 each) times its scale."""
    jax_block, params, block = _router_block(case)
    x = np.random.default_rng(5).standard_normal((1, 6, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_block)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
        weights, idx = block.route(torch.from_numpy(x[0]))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    assert idx.tolist() == [[0, 1]] * 6
    cfg = block.config
    if case == "deepseek_v3":
        want = 0.5 * cfg.routed_scaling_factor
        route = functools.partial(jax_v3.deepseek_route, n_group=4, topk_group=2, top_k=2,
                                  norm_topk_prob=True,
                                  routed_scaling_factor=cfg.routed_scaling_factor)
        _, jax_idx = jax.jit(route)(jax.nn.sigmoid(jnp.asarray(x[0]) @ params["gate"]["weight"]),
                                    params["gate"]["e_score_correction_bias"])
        assert np.asarray(jax_idx).tolist() == idx.tolist()
    elif case.startswith("deepseek_v2"):
        want = cfg.routed_scaling_factor / 8
    else:
        want = 0.5 * cfg.routed_scaling_factor
        _, jax_idx = jax.jit(jax_block.route)(params, jnp.asarray(x[0]))
        assert np.asarray(jax_idx).tolist() == idx.tolist()
    torch.testing.assert_close(weights, torch.full((6, 2), want), atol=1e-6, rtol=0)


def test_family_checkpoint_round_trip(family, tmp_path):
    """The port's checkpoint holds the JAX writer's keys and tensors: the
    routers' ``mlp.gate.weight`` in the hub's ``[E, H]`` (DeepSeek-V2's kept
    so by JAX, the others transposed back by its writer), the float32
    ``e_score_correction_bias`` where the family has one, one tensor per
    expert. ``from_pretrained`` reads it back with a clean report and the
    same weights and logits."""
    case, jax_model, params, model = family
    model.save_pretrained(tmp_path / "port")
    saved = load_file(str(tmp_path / "port" / "model.safetensors"))
    jax_model.save_pretrained(str(tmp_path / "jax"), params=params)
    written = load_file(str(tmp_path / "jax" / "model.safetensors"))
    cfg = model.config
    assert saved["model.layers.1.mlp.gate.weight"].shape == (cfg.n_routed_experts,
                                                            cfg.hidden_size)
    assert ("model.layers.1.mlp.gate.e_score_correction_bias" in saved) == (
        FAMILIES[case][0] not in ("deepseek_v2", "mistral4"))
    assert "model.layers.1.mlp.experts.0.down_proj.weight" in saved
    assert saved.keys() == written.keys()
    for name, t in saved.items():
        assert torch.equal(t, written[name]), name
    again = port.AutoModelForCausalLM.from_pretrained(tmp_path / "port", device="cpu")
    report = again.load_report
    assert not report.missing_keys and not report.unexpected_keys, report
    assert type(again) is type(model) and again.config.model_type == FAMILIES[case][0]
    for name, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[name], t), name
    with torch.no_grad():
        ids = torch.as_tensor(GEN_IDS[1:])
        assert torch.equal(again(ids).logits, model(ids).logits)
