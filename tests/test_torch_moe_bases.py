"""The port's OLMo-2, MiniMax-M2, ERNIE-4.5, ERNIE-4.5 MoE, Cohere, Cohere2,
Cohere2-MoE, HunYuan dense and HunYuan MoE against the JAX package's, on the
CPU, float32.

Each family is the JAX package's own test config (``tests/models/
test_decoder_families.py``, ``test_r3_decoders.py``, ``test_r3_decoders2.py``:
hidden 32, 4 query heads over 2 kv heads, head_dim 8) cut to 2 layers, with a
vocabulary of 256 for the shared prompts. Weights come from a numpy seed and
are carried to the port by ``params_from_jax``; every leaf is drawn, so the
routers' correction biases and ERNIE's biases are nonzero. ERNIE-4.5 runs
with ``use_bias``; Cohere with head-wise q/k norms; Cohere2 a sliding layer
(window 4) then a full one with no rope; Cohere2-MoE a dense full layer with
rope (``force_rope``) then a sliding sparse one, sigmoid routing and an
averaged shared expert; HunYuan dense the alpha rope; HunYuan MoE 4 then 3
experts, top 2 then 1.

Per family: logits of a left-padded batch within 2e-5 of JAX at valid
positions and greedy static ``generate`` tokens equal to the JAX model's
greedy choices (its forward over the sequence so far, one compiled program
for both tests), under both expert routes for the MoE families (JAX's
reference on its default route);
the configs' defaults attribute by attribute. The interleaved rope and the
alpha frequencies against JAX's. Each router inside its block against the
JAX block with planted cases: ERNIE's bias that picks but does not weigh and
its ``moe_norm_min`` floor, MiniMax-M2's bias, Cohere2-MoE's softmax,
sigmoid and renormalized sigmoid with summed and averaged shared experts,
HunYuan's per-layer top-k. Which layers rotate (Cohere2's full layers do
not, Cohere2-MoE's dense prefix does), against JAX and by the attention's
output under rope tables of other spacings. A ``save_pretrained`` ->
``from_pretrained`` round trip per family through the hub's per-expert
keys. Continuous
batching's greedy tokens equal static ``generate`` for Cohere2 (K6's route
with its window and a NoPE layer) and ERNIE-4.5 MoE.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu_torch as port
from transformers_tpu.models.cohere import CohereConfig, CohereForCausalLM
from transformers_tpu.models.cohere2 import Cohere2ForCausalLM
from transformers_tpu.models.cohere2.modeling_cohere2 import Cohere2Config
from transformers_tpu.models.cohere2_moe import Cohere2MoeConfig, Cohere2MoeForCausalLM
from transformers_tpu.models.cohere2_moe.modeling_cohere2_moe import Cohere2MoeSparseMoeBlock
from transformers_tpu.models.ernie4_5 import Ernie4_5Config, Ernie4_5ForCausalLM
from transformers_tpu.models.ernie4_5_moe import Ernie4_5_MoeConfig, Ernie4_5_MoeForCausalLM
from transformers_tpu.models.ernie4_5_moe.modeling_ernie4_5_moe import Ernie4_5_MoeSparseBlock
from transformers_tpu.models.hunyuan_v1_dense import (HunYuanDenseV1Config,
                                                      HunYuanDenseV1ForCausalLM)
from transformers_tpu.models.hunyuan_v1_moe import HunYuanMoEV1Config, HunYuanMoEV1ForCausalLM
from transformers_tpu.models.hunyuan_v1_moe.modeling_hunyuan_v1_moe import HunYuanMoEV1Moe
from transformers_tpu.models.minimax_m2 import MiniMaxM2Config, MiniMaxM2ForCausalLM
from transformers_tpu.models.minimax_m2.modeling_minimax_m2 import MiniMaxM2SparseMoeBlock
from transformers_tpu.models.olmo2 import Olmo2Config, Olmo2ForCausalLM
from transformers_tpu.ops import rope as jax_rope
from transformers_tpu_torch.core.safetensors import load_file
from transformers_tpu_torch.models.cohere2_moe import modeling_cohere2_moe as port_cohere2_moe
from transformers_tpu_torch.models.ernie4_5_moe import modeling_ernie4_5_moe as port_ernie_moe
from transformers_tpu_torch.models.hunyuan_v1_moe import modeling_hunyuan_v1_moe as port_hunyuan
from transformers_tpu_torch.models.minimax_m2 import modeling_minimax_m2 as port_minimax
from transformers_tpu_torch.ops import rope as port_rope
from test_torch_families import GEN_IDS, GEN_MASK
from test_torch_llama import TOL, _numpy_params, jax_forward
from torch_port_testing import one_torch_thread  # noqa: F401

TINY = dict(vocab_size=256, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
            pad_token_id=0, bos_token_id=1, eos_token_id=2)
COHERE2_MOE = dict(intermediate_size=32, head_dim=8, num_experts=4, num_experts_per_tok=2,
                   num_shared_experts=1, shared_expert_combination_strategy="average",
                   expert_selection_fn="sigmoid", first_k_dense_replace=1,
                   prefix_dense_intermediate_size=48, rms_norm_eps=1e-5, sliding_window=4,
                   sliding_window_pattern=2, logit_scale=0.0625)
BOTH = ("dense", "ragged")
FAMILIES = {  # model_type: (JAX config class, JAX model class, config, the port's routes)
    "olmo2": (Olmo2Config, Olmo2ForCausalLM, {}, (None,)),
    "minimax_m2": (MiniMaxM2Config, MiniMaxM2ForCausalLM, dict(
        intermediate_size=32, head_dim=8, num_local_experts=4, num_experts_per_tok=2), BOTH),
    "ernie4_5": (Ernie4_5Config, Ernie4_5ForCausalLM, dict(use_bias=True), (None,)),
    "ernie4_5_moe": (Ernie4_5_MoeConfig, Ernie4_5_MoeForCausalLM, dict(
        moe_intermediate_size=32, moe_k=2, moe_num_experts=4, moe_num_shared_experts=1,
        moe_layer_start_index=1), BOTH),
    "cohere": (CohereConfig, CohereForCausalLM, dict(logit_scale=0.0625, use_qk_norm=True),
               (None,)),
    "cohere2": (Cohere2Config, Cohere2ForCausalLM, dict(
        sliding_window=4, sliding_window_pattern=2, logit_scale=0.25), (None,)),
    "cohere2_moe": (Cohere2MoeConfig, Cohere2MoeForCausalLM, COHERE2_MOE, BOTH),
    "hunyuan_v1_dense": (HunYuanDenseV1Config, HunYuanDenseV1ForCausalLM, dict(
        head_dim=8, rope_scaling={"type": "dynamic", "alpha": 50.0}), (None,)),
    "hunyuan_v1_moe": (HunYuanMoEV1Config, HunYuanMoEV1ForCausalLM, dict(
        head_dim=8, num_experts=[4, 3], moe_topk=[2, 1]), BOTH),
}
CASES = [(family, route) for family, (*_, routes) in FAMILIES.items() for route in routes]


def _config(model_type, **extra):
    return dict(TINY, **FAMILIES[model_type][2], **extra)


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(model_type, JAX model, its params, the port's model with the same
    weights), float32, the port's on the CPU."""
    model_type = request.param
    jax_cfg_cls, jax_cls, _, _ = FAMILIES[model_type]
    config = _config(model_type)
    jax_model = jax_cls(jax_cfg_cls(**config), dtype=jnp.float32)
    params = _numpy_params(jax_model, 40 + len(model_type))
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
    return pytest.mark.parametrize("family,routed", CASES, indirect=True,
                                   ids=[f"{f}-{r}" for f, r in CASES])


def test_family_config_defaults_are_jax(family):
    """The port's config class, with no argument, has every attribute of the
    JAX config's defaults at the same value; the model's class is JAX's."""
    model_type, jax_model, _, model = family
    assert type(model).__name__ == type(jax_model).__name__
    defaults, jax_defaults = port.AutoConfig.for_model_type(model_type), FAMILIES[model_type][0]()
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


@_cases()
def test_family_logits_match_jax(routed):
    _, jax_model, params, model = routed
    kw = dict(input_ids=SEQ_IDS, attention_mask=SEQ_MASK, position_ids=_positions(SEQ_MASK))
    ref, _ = jax_forward(jax_model)(params, {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = model(**{k: torch.as_tensor(v) for k, v in kw.items()}).logits
    valid = SEQ_MASK.astype(bool)
    err = float(np.abs(out.numpy()[valid] - np.asarray(ref, np.float32)[valid]).max())
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
    static cache; Cohere2's window of 4 slides through the prompt and the
    decode steps."""
    _, jax_model, params, model = routed
    out = model.generate(torch.as_tensor(GEN_IDS), attention_mask=torch.as_tensor(GEN_MASK),
                         max_new_tokens=NEW, prompt_pad_multiple=8)
    np.testing.assert_array_equal(out[:, -NEW:].numpy(), _jax_greedy(jax_model, params))


@pytest.mark.parametrize("case", ["interleaved", "interleaved_partial", "alpha"])
def test_rope_matches_jax(case):
    """The interleaved tables and rotation (all of the head, and its leading
    half) against ``transformers_tpu/ops/rope.py`` within 1e-6; HunYuan's
    alpha frequencies against the JAX model's, to float64 rounding."""
    rng = np.random.default_rng(3)
    if case == "alpha":
        cfg = HunYuanDenseV1Config(**_config("hunyuan_v1_dense"))
        jax_inv = HunYuanDenseV1ForCausalLM(cfg, dtype=jnp.float32).model.inv_freq
        inv, scaling = port_rope.rope_inv_freq(port.AutoConfig.for_model_type(
            "hunyuan_v1_dense", **_config("hunyuan_v1_dense")))
        assert scaling == 1.0 and inv.shape == (4,)
        np.testing.assert_allclose(inv, np.asarray(jax_inv), rtol=1e-12)
        return
    d, d_rot = 16, 16 if case == "interleaved" else 8
    inv = 1.0 / (10000.0 ** (np.arange(0, d_rot, 2, dtype=np.float64) / d_rot))
    pos = rng.integers(0, 300, size=(2, 5))
    q = rng.standard_normal((2, 5, 4, d)).astype(np.float32)
    k = rng.standard_normal((2, 5, 2, d)).astype(np.float32)
    cos, sin = port_rope.compute_cos_sin_interleaved(torch.as_tensor(pos), inv, 0.5)

    @jax.jit
    def jax_rotated(pos, q, k):
        cos, sin = jax_rope.compute_cos_sin_interleaved(pos, inv, 0.5)
        return cos, sin, jax_rope.apply_rotary_pos_emb_interleaved(q, k, cos, sin)

    jcos, jsin, want = jax_rotated(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(k))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6, rtol=0)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6, rtol=0)
    got = port_rope.apply_rotary_pos_emb_interleaved(torch.from_numpy(q), torch.from_numpy(k),
                                                     cos, sin)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    if d_rot < d:  # the trailing half passes through
        np.testing.assert_array_equal(got[0][..., d_rot:].numpy(), q[..., d_rot:])


def _plant(w_out_in, logits):
    """Hidden rows whose router logits (through the ``[E, H]`` weight) are
    ``logits`` [T, E]."""
    return np.linalg.lstsq(w_out_in, logits.T, rcond=None)[0].T.astype(np.float32)


def _block_case(case):
    """(JAX block, its params, the port's block with the same weights, hidden
    [1, T, H], a check of the port's routing)."""
    rng = np.random.default_rng(21)
    h, e, t = 32, 4, 6
    logits = rng.standard_normal((t, e)).astype(np.float32)
    kw = dict(hidden_size=h, intermediate_size=16, initializer_range=0.02)
    if case.startswith("ernie"):
        norm_min = 0.9 if case == "ernie_norm_min" else 1e-12
        cfg = dict(kw, moe_intermediate_size=16, moe_k=2, moe_num_experts=e,
                   moe_num_shared_experts=1, moe_norm_min=norm_min)
        jax_cls, port_cls = Ernie4_5_MoeSparseBlock, port_ernie_moe.Ernie4_5_MoeSparseMoeBlock
        extra = ()
        jax_cfg, port_cfg = Ernie4_5_MoeConfig(**cfg), port.Ernie4_5_MoeConfig(**cfg)
        # row 0: expert 2's probability is below expert 1's, its bias lifts it above
        logits[0] = [2.0, 1.0, 0.9, -1.0]
        bias = np.array([[0.0, 0.0, 0.2, 0.0]], np.float32)
    elif case == "minimax":
        cfg = dict(kw, num_local_experts=e, num_experts_per_tok=2)
        jax_cls, port_cls = MiniMaxM2SparseMoeBlock, port_minimax.MiniMaxM2SparseMoeBlock
        extra = ()
        jax_cfg, port_cfg = MiniMaxM2Config(**cfg), port.MiniMaxM2Config(**cfg)
        logits[0] = [2.0, 1.0, 0.8, -1.0]
        bias = np.array([0.0, 0.0, 0.2, 0.0], np.float32)
    elif case.startswith("cohere2"):
        selection, strategy = case.split("-")[1:]
        cfg = dict(kw, num_experts=e, num_experts_per_tok=2, num_shared_experts=1,
                   expert_selection_fn=selection.replace("_renorm", ""),
                   norm_topk_prob=selection.endswith("_renorm"),
                   shared_expert_combination_strategy=strategy)
        jax_cls, port_cls, extra = (Cohere2MoeSparseMoeBlock,
                                    port_cohere2_moe.Cohere2MoeSparseMoeBlock, ())
        jax_cfg, port_cfg = Cohere2MoeConfig(**cfg), port.Cohere2MoeConfig(**cfg)
        bias = None
    else:  # hunyuan, layer 1 of a model with 4 then 3 experts, top 2 then 1
        cfg = dict(kw, num_experts=[4, 3], moe_topk=[2, 1], num_hidden_layers=2)
        jax_cls, port_cls, extra = HunYuanMoEV1Moe, port_hunyuan.HunYuanMoEV1Moe, (1,)
        jax_cfg, port_cfg = HunYuanMoEV1Config(**cfg), port.HunYuanMoEV1Config(**cfg)
        logits, bias = logits[:, :3], None
    jax_block = jax_cls(jax_cfg, *extra, dtype=jnp.float32, param_dtype=jnp.float32)
    params = jax.tree.map(lambda s: jnp.asarray(0.3 * rng.standard_normal(s.shape), jnp.float32),
                          jax_block.init_abstract())
    flat = port.params_from_jax(jax.tree.map(np.asarray, params))
    gate = next(k for k in flat if k.startswith("gate.") and k.endswith("weight"))
    w = flat[gate].numpy()  # [E, H], the router's weight in the hub layout
    if bias is not None:
        name = ("moe_statics.e_score_correction_bias" if case.startswith("ernie")
                else "e_score_correction_bias")
        flat[name] = torch.from_numpy(bias)
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: jnp.asarray(bias) if "e_score_correction_bias" in
            jax.tree_util.keystr(p) else v, params)
    x = _plant(w, logits)[None]
    block = port_cls(port_cfg, *extra, dtype=torch.float32, param_dtype=torch.float32,
                     device="cpu")
    block.load_state_dict(flat)
    return jax_block, params, block, x, logits, bias


ROUTER_CASES = ["ernie", "ernie_norm_min", "minimax", "cohere2-softmax-sum",
                "cohere2-softmax-average", "cohere2-sigmoid-sum",
                "cohere2-sigmoid_renorm-average", "hunyuan"]


@pytest.mark.parametrize("case", ROUTER_CASES)
def test_router_in_its_block_matches_jax(case):
    """The block's output within 2e-5 of the JAX block's on rows whose router
    logits are planted, and the port's routing shows the planted case."""
    jax_block, params, block, x, logits, bias = _block_case(case)
    ref = np.asarray(jax.jit(jax_block)(params, jnp.asarray(x)))
    with torch.no_grad():
        out = block(torch.from_numpy(x)).numpy()
        weights, idx = block.route(torch.from_numpy(x[0]))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    probs = torch.softmax(torch.from_numpy(logits), dim=-1)
    if case.startswith("ernie") or case == "minimax":
        scores = probs if case.startswith("ernie") else torch.sigmoid(torch.from_numpy(logits))
        assert sorted(scores[0].argsort(descending=True)[:2].tolist()) == [0, 1]
        assert sorted(idx[0].tolist()) == [0, 2]  # the bias lifts expert 2 above expert 1
        picked = scores.gather(-1, idx)  # weighted by the unbiased scores
        total = picked.sum(-1, keepdim=True)
        norm = total.clamp_min(0.9) if case == "ernie_norm_min" else total
        torch.testing.assert_close(weights, picked / norm, atol=1e-6, rtol=0)
        if case == "ernie_norm_min":
            assert (total < 0.9).any() and (weights.sum(-1) < 1 - 1e-3).any()
    elif case.startswith("cohere2"):
        top = torch.from_numpy(logits).topk(2).values
        want = (torch.softmax(top, -1) if "softmax" in case else torch.sigmoid(top))
        if "renorm" in case:
            want = want / want.sum(-1, keepdim=True)
        torch.testing.assert_close(weights, want, atol=1e-6, rtol=0)
    else:
        assert block.top_k == 1 and idx.shape == (6, 1) and weights.eq(1.0).all()
        assert block.experts.gate_proj.shape[0] == 3


@pytest.mark.parametrize("model_type", ["cohere2", "cohere2_moe"])
def test_which_layers_rotate(model_type):
    """At 4 layers each attention rotates as JAX's does (``apply_rope``):
    Cohere2's full layers (1, 3) not at all, Cohere2-MoE's dense full layer 0
    (``force_rope``) and its sliding ones, but not its sparse full layer 2. A
    layer that does not rotate gives the same output under tables of
    positions spaced by 3 as by 1; one that does, another (rope sees the
    distances, which the spacing changes)."""
    config = _config(model_type, num_hidden_layers=4)
    jax_model = FAMILIES[model_type][1](FAMILIES[model_type][0](**config), dtype=jnp.float32)
    model = port.AutoModelForCausalLM.from_config(
        port.AutoConfig.for_model_type(model_type, **config), dtype=torch.float32,
        device="cpu").init_weights(5)
    layer_types = model.config.layer_types
    rotating = [layer.self_attn.apply_rope for layer in model.model.layers]
    assert rotating == [layer.self_attn.apply_rope for layer in jax_model.model.layers]
    if model_type == "cohere2":
        assert rotating == [True, False, True, False]
    else:
        assert model.config.mlp_layer_types[0] == "dense" and layer_types[0] == "full_attention"
        assert rotating == [True, True, False, True]
    s = 6
    hidden = torch.randn(1, s, 32, generator=torch.Generator().manual_seed(1))
    args = {"q_positions": torch.arange(s, dtype=torch.int32)[None],
            "kv_valid": torch.ones((1, s), dtype=torch.int32), "is_causal": True,
            "sliding_window": None}
    for i, layer in enumerate(model.model.layers):
        outs = [layer.self_attn(hidden, *model.model.compute_rope(torch.arange(s)[None] * step),
                                args, None, 0) for step in (1, 3)]
        assert torch.equal(outs[0], outs[1]) != rotating[i], i


def test_family_checkpoint_round_trip(family, tmp_path):
    """The port's checkpoint holds the hub's keys, one tensor per expert; they
    are the JAX writer's keys and tensors, but for Cohere2-MoE, whose experts
    the JAX package writes stacked (``experts.gate_up_proj``, ``down_proj``):
    the port's per-expert tensors are its slices. ``from_pretrained`` reads
    the file back with a clean report and the same weights and logits."""
    model_type, jax_model, params, model = family
    model.save_pretrained(tmp_path / "port")
    saved = load_file(str(tmp_path / "port" / "model.safetensors"))
    jax_model.save_pretrained(str(tmp_path / "jax"), params=params)
    written = load_file(str(tmp_path / "jax" / "model.safetensors"))
    moe = FAMILIES[model_type][3] == BOTH
    assert any(".experts.0." in k for k in saved) == moe
    if model_type == "cohere2_moe":
        gate_up = written.pop("model.layers.1.mlp.experts.gate_up_proj")
        down = written.pop("model.layers.1.mlp.experts.down_proj")
        for e in range(4):
            written[f"model.layers.1.mlp.experts.{e}.gate_proj.weight"] = gate_up[e, :32]
            written[f"model.layers.1.mlp.experts.{e}.up_proj.weight"] = gate_up[e, 32:]
            written[f"model.layers.1.mlp.experts.{e}.down_proj.weight"] = down[e]
    if model_type == "ernie4_5_moe":
        assert saved["model.layers.1.mlp.gate.weight"].shape == (4, 32)
    assert saved.keys() == written.keys()
    for name, t in saved.items():
        assert torch.equal(t, written[name]), name
    again = port.AutoModelForCausalLM.from_pretrained(tmp_path / "port", device="cpu")
    report = again.load_report
    assert not report.missing_keys and not report.unexpected_keys, report
    assert type(again) is type(model) and again.config.model_type == model_type
    for name, t in model.state_dict().items():
        assert torch.equal(again.state_dict()[name], t), name
    with torch.no_grad():
        ids = torch.as_tensor(GEN_IDS[1:])
        assert torch.equal(again(ids).logits, model(ids).logits)


@pytest.mark.parametrize("family", ["cohere2", "ernie4_5_moe"], indirect=True)
def test_family_continuous_batching_matches_static_generate(family):
    """Prompts of 3-12 tokens through the paged engine (4-token prefill chunks
    over pages of 4) give the static-cache generate's greedy tokens: Cohere2's
    decode on K6's route (the window of 4 on its sliding layer, no rope on
    its full one) and ERNIE-4.5 MoE's (interleaved rope, the ragged route)."""
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
