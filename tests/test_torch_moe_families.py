"""The port's OLMoE, Phi-3.5-MoE, Laguna and gpt-oss against the JAX
package's, on the CPU, float32.

Each family is a tiny model (2 layers, hidden 128, head_dim 64, 4 experts, 2
a token) whose weights are made from a numpy seed and carried to the port by
``params_from_jax``; every leaf is drawn, so Laguna's e-score correction
bias, gpt-oss's sinks and every bias are nonzero. OLMoE has one query head
per kv head (as OLMoE-1B-7B) and clips q/k/v at 2; Phi-3.5-MoE runs LongRoPE
and an ``lm_head`` bias; Laguna has one sliding and one full layer (half the
head dim rotated), 4 then 8 query heads, a dense layer 0, a router softcap
and a routed scale of 2.5; gpt-oss a sliding then a full layer with yarn.

Per family: logits of a left-padded batch within 2e-5 of JAX at valid
positions and greedy static ``generate`` tokens equal to JAX's, under both
expert routes for OLMoE, Phi-3.5-MoE and Laguna (JAX's reference on its
default route) and the all-experts einsum route for gpt-oss. Each router
function against JAX's, indices exact and weights within 1e-6, with planted
cases: a sparsemixer threshold that drops a candidate and one that keeps it,
a tie, an e-score bias that changes Laguna's pick, Laguna's softcap,
gpt-oss's biased top-k then softmax. gpt-oss's experts (interleaved gate/up,
clamps, biases) against JAX's. A ``save_pretrained`` -> ``from_pretrained``
round trip per family with the checkpoint's keys (per expert for three,
stacked for gpt-oss), which are the JAX writer's but for OLMoE's q/k norms
(ROADMAP §C). Continuous batching's greedy tokens equal static ``generate``
for OLMoE (K6's route) and gpt-oss (the sinks' gathered route).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu_torch as port
from transformers_tpu.models.gpt_oss import GptOssConfig, GptOssForCausalLM
from transformers_tpu.models.gpt_oss.modeling_gpt_oss import GptOssExperts, GptOssRouter
from transformers_tpu.models.laguna import LagunaConfig, LagunaForCausalLM
from transformers_tpu.models.laguna.modeling_laguna import LagunaTopKRouter
from transformers_tpu.models.olmoe import OlmoeConfig, OlmoeForCausalLM
from transformers_tpu.models.phimoe import PhimoeConfig, PhimoeForCausalLM
from transformers_tpu.models.phimoe.modeling_phimoe import sparsemixer_route
from transformers_tpu_torch.core.safetensors import load_file
from transformers_tpu_torch.models.gpt_oss import modeling_gpt_oss as port_gpt_oss
from transformers_tpu_torch.models.laguna import modeling_laguna as port_laguna
from transformers_tpu_torch.models.phimoe import modeling_phimoe as port_phimoe
from transformers_tpu_torch.ops.moe import topk_routing
from test_torch_families import GEN_IDS, GEN_MASK
from test_torch_llama import IDS, MASK, POS, TOL, VALID, _numpy_params, jax_forward
from torch_port_testing import one_torch_thread  # noqa: F401

BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            max_position_embeddings=128, rms_norm_eps=1e-5, bos_token_id=1, eos_token_id=2,
            pad_token_id=0)
MOE = dict(num_experts=4, num_experts_per_tok=2)
FAMILIES = {  # model_type: (JAX config class, JAX model class, config, the port's routes)
    "olmoe": (OlmoeConfig, OlmoeForCausalLM, dict(
        MOE, num_attention_heads=2, num_key_value_heads=2, clip_qkv=2.0, norm_topk_prob=False),
        ("dense", "ragged")),
    "phimoe": (PhimoeConfig, PhimoeForCausalLM, dict(
        num_local_experts=4, num_experts_per_tok=2, lm_head_bias=True,
        rope_scaling={"type": "longrope", "original_max_position_embeddings": 64,
                      "short_factor": [1.0 + 0.02 * i for i in range(32)],
                      "long_factor": [1.0 + 0.1 * i for i in range(32)]}),
        ("dense", "ragged")),
    "laguna": (LagunaConfig, LagunaForCausalLM, dict(
        MOE, intermediate_size=256, layer_types=["sliding_attention", "full_attention"],
        sliding_window=5, num_attention_heads_per_layer=[4, 8], moe_intermediate_size=64,
        shared_expert_intermediate_size=96, moe_routed_scaling_factor=2.5,
        moe_router_logit_softcapping=1.5), ("dense", "ragged")),
    "gpt_oss": (GptOssConfig, GptOssForCausalLM, dict(
        num_local_experts=4, num_experts_per_tok=2, sliding_window=5), (None,)),
}
CASES = [(family, route) for family, (*_, routes) in FAMILIES.items() for route in routes]


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(model_type, JAX model, its params, the port's model with the same
    weights), float32, the port's on the CPU."""
    model_type = request.param
    jax_cfg_cls, jax_cls, config, _ = FAMILIES[model_type]
    config = dict(BASE, **config)
    jax_model = jax_cls(jax_cfg_cls(**config), dtype=jnp.float32)
    params = _numpy_params(jax_model, 16 + len(model_type))
    model = port.AutoModelForCausalLM.from_config(
        port.AutoConfig.for_model_type(model_type, **config), dtype=torch.float32, device="cpu")
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, params)), strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return model_type, jax_model, params, model


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
    return pytest.mark.parametrize("family,routed", [(f, r) for f, r in CASES],
                                   indirect=True, ids=[f"{f}-{r}" for f, r in CASES])


def test_family_builds_the_layers_jax_builds(family):
    """The port's classes, windows, head counts and rope widths per layer
    are the JAX model's; the configs' defaults are the JAX configs'."""
    model_type, jax_model, _, model = family
    assert type(model).__name__ == type(jax_model).__name__
    rope = model.model.compute_rope(torch.arange(3)[None])
    jax_rope = jax_model.model.compute_rope(jnp.arange(3)[None])
    for i, (layer, jax_layer) in enumerate(zip(model.model.layers, jax_model.model.layers)):
        attn, jax_attn = layer.self_attn, jax_layer.self_attn
        assert (attn.sliding_window, attn.num_heads, attn.num_kv_heads, attn.head_dim) == (
            jax_attn.sliding_window, jax_attn.num_heads, jax_attn.num_kv_heads,
            jax_attn.head_dim)
        cos, jax_cos = model.model.rope_for_layer(rope, i)[0], jax_model.model.rope_for_layer(
            jax_rope, i)[0]
        np.testing.assert_allclose(cos.numpy(), np.asarray(jax_cos), atol=1e-6, rtol=0)
    defaults, jax_defaults = port.AutoConfig.for_model_type(model_type), FAMILIES[model_type][0]()
    for key, value in vars(jax_defaults).items():
        if not key.startswith("_") and key not in ("architectures", "dtype"):
            assert getattr(defaults, key) == value, key


@_cases()
def test_family_logits_match_jax(routed):
    _, jax_model, params, model = routed
    kw = dict(input_ids=IDS, attention_mask=MASK, position_ids=POS)
    ref, _ = jax_forward(jax_model)(params, {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = model(**{k: torch.as_tensor(v) for k, v in kw.items()}).logits
    err = float(np.abs(out.numpy()[VALID] - np.asarray(ref, np.float32)[VALID]).max())
    assert err < TOL, f"max |port - jax| = {err}"


def _jax_greedy(jax_model, params):
    ids = getattr(jax_model, "_test_greedy", None)
    if ids is None:
        ids = jax_model._test_greedy = np.asarray(jax_model.generate(
            params, input_ids=jnp.asarray(GEN_IDS), attention_mask=jnp.asarray(GEN_MASK),
            max_new_tokens=10, prompt_pad_multiple=8))
    return ids


@_cases()
def test_family_greedy_generate_matches_jax(routed):
    """Left-padded prompts bucketed to 16 slots, 10 new tokens; the windows
    of 5 slide through the prompt and the decode steps."""
    _, jax_model, params, model = routed
    out = model.generate(torch.as_tensor(GEN_IDS), attention_mask=torch.as_tensor(GEN_MASK),
                         max_new_tokens=10, prompt_pad_multiple=8)
    np.testing.assert_array_equal(out.numpy(), _jax_greedy(jax_model, params))


def test_family_checkpoint_round_trip(family, tmp_path):
    """The port's checkpoint holds the hub's keys: one tensor per expert for
    OLMoE, Phi-3.5-MoE and Laguna, gpt-oss's stacked tensors whole; they are
    the keys and tensors the JAX writer writes, except that the JAX package
    writes OLMoE's q/k norms under its own names (``full_q_norm``), where the
    hub and the port write ``q_norm``. ``from_pretrained`` reads the file
    back with a clean report and the same weights and logits."""
    model_type, jax_model, params, model = family
    model.save_pretrained(tmp_path / "port")
    saved = load_file(str(tmp_path / "port" / "model.safetensors"))
    per_expert = {k for k in saved if ".experts.0." in k}
    if model_type == "gpt_oss":
        assert not per_expert
        assert saved["model.layers.0.mlp.experts.gate_up_proj"].shape == (4, 128, 128)
        assert saved["model.layers.0.mlp.router.weight"].shape == (4, 128)
    else:
        assert len(per_expert) == 3 * (1 if model_type == "laguna" else 2)
    jax_model.save_pretrained(str(tmp_path / "jax"), params=params)
    written = load_file(str(tmp_path / "jax" / "model.safetensors"))
    renamed = {k.replace(".full_q_norm.", ".q_norm.").replace(".full_k_norm.", ".k_norm."): t
               for k, t in written.items()}
    assert (renamed != written) == (model_type == "olmoe")
    assert saved.keys() == renamed.keys()
    for name, t in saved.items():
        assert torch.equal(t, renamed[name]), name
    again = port.AutoModelForCausalLM.from_pretrained(tmp_path / "port", device="cpu")
    report = again.load_report
    assert not report.missing_keys and not report.unexpected_keys, report
    assert type(again) is type(model) and again.config.model_type == model_type
    for name, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[name], t), name
    with torch.no_grad():
        ids = torch.as_tensor(GEN_IDS[1:])
        assert torch.equal(again(ids).logits, model(ids).logits)


@pytest.mark.parametrize("family", ["olmoe", "gpt_oss"], indirect=True)
def test_family_continuous_batching_matches_static_generate(family):
    """Prompts of 3-12 tokens through the paged engine (4-token prefill
    chunks over pages of 4) give the static-cache generate's greedy tokens:
    OLMoE's decode on the paged kernel's route, gpt-oss's (sinks) on the
    gathered context through the eager attention."""
    model = family[3]
    eos = model.config.eos_token_id
    prompts = [[5, 77, 140, 9, 33, 210, 6, 4, 19, 3, 200, 8], [61, 18, 99], [7, 2, 8, 45, 90, 11]]
    got = model.generate_batch(prompts, max_new_tokens=8, num_blocks=32, block_size=4,
                               token_budget=4)
    for prompt, tokens in zip(prompts, got):
        out = model.generate(torch.tensor([prompt]), max_new_tokens=8, prompt_pad_multiple=1)
        want = out[0, len(prompt):].tolist()
        if eos in want:
            want = want[:want.index(eos) + 1]
        assert tokens == want


def _logits(t=24, e=6, seed=3, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal((t, e))).astype(np.float32)


def _planted_sparsemixer():
    """Rows 0-3 planted (jitter 0.01: a candidate within 2% of the maximum
    stays in the softmax): row 0 keeps its runner-up (gap 1%), row 1 drops
    it (gap 5%), row 2 ties its maximum at experts 1 and 4 (the first pick
    is 1, the second 4), row 3 ties the runner-up at experts 0 and 5."""
    logits = _logits()
    logits[0, :] = [1.0, 3.0, 2.97, -1.0, 0.5, 0.0]
    logits[1, :] = [1.0, 3.0, 2.85, -1.0, 0.5, 0.0]
    logits[2, :] = [0.2, 2.0, -0.5, 1.0, 2.0, 0.1]
    logits[3, :] = [1.5, -0.2, 0.3, 2.5, 0.0, 1.5]
    return logits


def _laguna_router_case(softcap):
    """A LagunaTopKRouter's weights and inputs, and the e-score bias, with row
    0 planted so that the bias changes its pick: expert 2's score is below
    expert 0's and 1's, but its bias lifts it above expert 1."""
    rng = np.random.default_rng(5)
    cfg = LagunaConfig(hidden_size=16, num_experts=6, num_experts_per_tok=2,
                       moe_router_logit_softcapping=softcap)
    w = (0.6 * rng.standard_normal((16, 6))).astype(np.float32)
    x = rng.standard_normal((20, 16)).astype(np.float32)
    x[0] = np.linalg.lstsq(w.T, np.array([3.0, 2.0, 1.5, -2.0, -1.0, -3.0], np.float32),
                           rcond=None)[0]
    bias = np.array([0.0, 0.0, 0.2, 0.05, -0.1, 0.0], np.float32)
    return cfg, w, x, bias


@pytest.mark.parametrize("case", ["sparsemixer", "laguna", "laguna_softcap", "gpt_oss"])
def test_router_matches_jax(case):
    """Indices exact, weights within 1e-6."""
    if case == "sparsemixer":
        logits = _planted_sparsemixer()
        ref_w, ref_idx = jax.jit(sparsemixer_route, static_argnums=1)(jnp.asarray(logits), 0.01)
        w, idx = port_phimoe.sparsemixer_route(torch.from_numpy(logits), 0.01)
        assert idx[2].tolist() == [1, 4] and idx[3].tolist() == [3, 0]
        # the 1%-gap runner-up shares the first pick's softmax; the 5% one does not
        assert 0.45 < float(w[0, 0]) < 0.55 and float(w[1, 0]) == 1.0
    elif case.startswith("laguna"):
        softcap = 1.0 if case.endswith("softcap") else 0.0
        cfg, w_in, x, bias = _laguna_router_case(softcap)
        jax_router = LagunaTopKRouter(cfg, dtype=jnp.float32, param_dtype=jnp.float32)
        params = {"gate": {"weight": jnp.asarray(w_in)},
                  "e_score_correction_bias": jnp.asarray(bias)}
        _, ref_w, ref_idx = jax.jit(jax_router)(params, jnp.asarray(x))
        router = port_laguna.LagunaTopKRouter(cfg, dtype=torch.float32,
                                              param_dtype=torch.float32, device="cpu")
        router.load_state_dict({"gate.weight": torch.from_numpy(w_in.T.copy()),
                                "e_score_correction_bias": torch.from_numpy(bias)})
        with torch.no_grad():
            w, idx = router(torch.from_numpy(x))
        scores = x[0] @ w_in
        if softcap:
            scores = np.tanh(scores / softcap) * softcap
        assert sorted(np.argsort(-scores)[:2].tolist()) == [0, 1]  # without the bias
        assert sorted(idx[0].tolist()) == [0, 2]  # the bias lifts expert 2 above expert 1
    else:
        rng = np.random.default_rng(9)
        cfg = GptOssConfig(hidden_size=16, num_local_experts=6, num_experts_per_tok=3)
        w_in = (0.5 * rng.standard_normal((16, 6))).astype(np.float32)
        b = np.array([0.0, 3.0, 0.0, -3.0, 0.5, 0.0], np.float32)
        x = rng.standard_normal((20, 16)).astype(np.float32)
        ref_w, ref_idx = jax.jit(GptOssRouter(cfg, dtype=jnp.float32, param_dtype=jnp.float32))(
            {"weight": jnp.asarray(w_in), "bias": jnp.asarray(b)}, jnp.asarray(x))
        router = port_gpt_oss.GptOssRouter(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                           device="cpu")
        router.load_state_dict({"weight": torch.from_numpy(w_in.T.copy()),
                                "bias": torch.from_numpy(b)})
        with torch.no_grad():
            w, idx = router(torch.from_numpy(x))
        assert (idx == 1).any(dim=-1).float().mean() > 0.9  # the +3 bias is felt
        np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, atol=1e-6)  # softmax over the kept
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(w.float().numpy(), np.asarray(ref_w), atol=1e-6, rtol=0)


def test_gpt_oss_experts_match_jax():
    """Interleaved gate/up columns, the clamps (most gate and up values pass
    +-7 at these scales) and the biases, against JAX's ``GptOssExperts``,
    within 2e-5 of the output's scale."""
    rng = np.random.default_rng(11)
    e, h, i, t = 4, 16, 12, 9
    cfg = GptOssConfig(hidden_size=h, intermediate_size=i, num_local_experts=e)
    params = {"gate_up_proj": 3.0 * rng.standard_normal((e, h, 2 * i)),
              "gate_up_proj_bias": rng.standard_normal((e, 2 * i)),
              "down_proj": 0.2 * rng.standard_normal((e, i, h)),
              "down_proj_bias": rng.standard_normal((e, h))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    x = rng.standard_normal((t, h)).astype(np.float32)
    weights, idx = topk_routing(torch.from_numpy(_logits(t, e, seed=12)), 2,
                                             renormalize=False, pre_softmax=False)
    ref = jax.jit(GptOssExperts(cfg, dtype=jnp.float32, param_dtype=jnp.float32))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(weights.numpy()), jnp.asarray(idx.numpy()))
    experts = port_gpt_oss.GptOssExperts(cfg, dtype=torch.float32, param_dtype=torch.float32,
                                         device="cpu")
    experts.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    with torch.no_grad():
        out = experts(torch.from_numpy(x), weights, idx)
    gate_up = np.einsum("th,ehi->eti", x, params["gate_up_proj"])
    assert (np.abs(gate_up) > 7).mean() > 0.4
    ref = np.asarray(ref)
    err = float(np.abs(out.numpy() - ref).max())
    assert err < TOL * float(np.abs(ref).max()), err
