"""The port's Llama-skeleton families against the JAX package's, on the CPU:
Mistral, Qwen2, Qwen3, Phi-3, Gemma, Gemma2 and the Gemma-3 text decoder,
and the mixture-of-experts Mixtral, Qwen2-MoE and Qwen3-MoE.

Each family is a tiny model (2 or 3 layers, hidden 128, head_dim 64, the
kernels' routes as on the card) whose weights are made from a numpy seed
and carried to the port by ``params_from_jax``; Phi-3 runs at head_dim 96
(hidden 192, 2 heads, LongRoPE) and Gemma at head_dim 256. The windows are
5 slots, so they bite in the 10-token prompts; Gemma-3's sliding layers run
the local rope table and its full layer the linearly scaled global one. The
MoE families have 4 experts, 2 per token: Mixtral's renormalized, Qwen2-MoE
with its shared expert and a dense layer (``mlp_only_layers``) between two
sparse ones, Qwen3-MoE with ``norm_topk_prob`` on the ragged route (the
others on the default dense one).

Per family: logits of a left-padded batch within 2e-5 of JAX at valid
positions (float32; the frameworks sum in different orders), greedy static
``generate`` tokens equal to JAX's, and a checkpoint written by the JAX
package read by the port's ``AutoModelForCausalLM`` with no missing or
unexpected keys (and no ``lm_head`` in a tied model's file), saved with the
JAX writer's keys and tensors (one tensor per expert for the MoE families,
whose experts the port keeps stacked) and read back. For Mistral and
Gemma-3, whose windows reach the paged path, and for Qwen3-MoE,
continuous batching's greedy tokens equal the port's static ``generate``.
For the three Gemma families, the loss of a right-padded batch and every
parameter's gradient equal ``jax.value_and_grad`` of the JAX family's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import transformers_tpu_torch as port
from transformers_tpu.models.gemma import GemmaConfig, GemmaForCausalLM
from transformers_tpu.models.gemma2 import Gemma2Config, Gemma2ForCausalLM
from transformers_tpu.models.gemma3 import Gemma3ForCausalLM, Gemma3TextConfig
from transformers_tpu.models.mistral import MistralConfig, MistralForCausalLM
from transformers_tpu.models.mixtral import MixtralConfig, MixtralForCausalLM
from transformers_tpu.models.phi3 import Phi3Config, Phi3ForCausalLM
from transformers_tpu.models.qwen2 import Qwen2Config, Qwen2ForCausalLM
from transformers_tpu.models.qwen2_moe import Qwen2MoeConfig, Qwen2MoeForCausalLM
from transformers_tpu.models.qwen3 import Qwen3Config, Qwen3ForCausalLM
from transformers_tpu.models.qwen3_moe import Qwen3MoeConfig, Qwen3MoeForCausalLM
from transformers_tpu_torch.core.safetensors import load_file
from transformers_tpu_torch.ops.fused_decode import KERNEL_HEAD_DIMS
from test_torch_llama import IDS, MASK, POS, TOL, VALID, _numpy_params, jax_forward
from torch_port_testing import one_torch_thread  # noqa: F401

BASE = dict(vocab_size=256, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            max_position_embeddings=128, rms_norm_eps=1e-5, bos_token_id=1, eos_token_id=2,
            pad_token_id=0)
HALF_ROPE = 48  # Phi-3's rotary pairs at head_dim 96
FAMILIES = {  # model_type: (JAX config class, JAX model class, config)
    "mistral": (MistralConfig, MistralForCausalLM, dict(sliding_window=5)),
    "qwen2": (Qwen2Config, Qwen2ForCausalLM,
              dict(use_sliding_window=True, sliding_window=5, max_window_layers=1)),
    "qwen3": (Qwen3Config, Qwen3ForCausalLM, {}),
    "phi3": (Phi3Config, Phi3ForCausalLM, dict(
        hidden_size=192, num_attention_heads=2, num_key_value_heads=2, head_dim=None,
        max_position_embeddings=128, original_max_position_embeddings=64,
        rope_scaling={"type": "longrope",
                      "short_factor": [1.0 + 0.02 * i for i in range(HALF_ROPE)],
                      "long_factor": [1.0 + 0.1 * i for i in range(HALF_ROPE)]})),
    "gemma": (GemmaConfig, GemmaForCausalLM, dict(head_dim=256)),
    "gemma2": (Gemma2Config, Gemma2ForCausalLM, dict(sliding_window=5)),
    "gemma3_text": (Gemma3TextConfig, Gemma3ForCausalLM, dict(
        num_hidden_layers=3, sliding_window=5, sliding_window_pattern=3,
        rope_scaling={"rope_type": "linear", "factor": 8.0})),
    # tests/models/test_decoder_families.py's MoE configs at this file's widths
    "mixtral": (MixtralConfig, MixtralForCausalLM, dict(num_local_experts=4,
                                                        num_experts_per_tok=2)),
    "qwen2_moe": (Qwen2MoeConfig, Qwen2MoeForCausalLM, dict(
        num_hidden_layers=3, mlp_only_layers=[1], num_experts=4, num_experts_per_tok=2,
        moe_intermediate_size=64, shared_expert_intermediate_size=256, norm_topk_prob=False,
        use_sliding_window=False)),
    "qwen3_moe": (Qwen3MoeConfig, Qwen3MoeForCausalLM, dict(
        num_experts=4, num_experts_per_tok=2, moe_intermediate_size=64, norm_topk_prob=True,
        experts_implementation="ragged")),
}
CB_FAMILIES = ("mistral", "gemma3_text", "qwen3_moe")


def _config(model_type):
    return {k: v for k, v in dict(BASE, **FAMILIES[model_type][2]).items() if v is not None}


@pytest.fixture(scope="module", params=list(FAMILIES))
def family(request):
    """(model_type, JAX model, its params, the port's model with the same
    weights), float32, the port's on the CPU."""
    model_type = request.param
    jax_cfg_cls, jax_cls, _ = FAMILIES[model_type]
    config = _config(model_type)
    jax_model = jax_cls(jax_cfg_cls(**config), dtype=jnp.float32)
    # the Gemma families' norms compute x * (1 + weight): weights around 0
    params = _numpy_params(jax_model, len(model_type),
                           norm_centre=0.0 if model_type.startswith("gemma") else 1.0)
    model = port.AutoModelForCausalLM.from_config(
        port.AutoConfig.for_model_type(model_type, **config), dtype=torch.float32, device="cpu")
    missing, unexpected = model.load_state_dict(
        port.params_from_jax(jax.tree.map(np.asarray, params)), strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    return model_type, jax_model, params, model


def test_family_config_and_routes(family):
    """The port builds the family's own classes, and its layers take the
    kernels' head_dims and the windows the JAX layers have."""
    model_type, jax_model, _, model = family
    assert type(model).__name__ == type(jax_model).__name__
    assert model.config.model_type == model_type
    jax_windows = [layer.self_attn.sliding_window for layer in jax_model.model.layers]
    assert [layer.self_attn.sliding_window for layer in model.model.layers] == jax_windows
    assert any(jax_windows) == (model_type in ("mistral", "qwen2", "gemma2", "gemma3_text"))
    attn = model.model.layers[0].self_attn
    assert attn.head_dim in KERNEL_HEAD_DIMS
    # the kernels take dense tensors: a fused qkv_proj (Phi-3) hands out copies
    q, k, v = attn.project_qkv(torch.zeros(2, 3, model.config.hidden_size))
    assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()


def test_family_logits_match_jax(family):
    _, jax_model, params, model = family
    kw = dict(input_ids=IDS, attention_mask=MASK, position_ids=POS)
    ref, _ = jax_forward(jax_model)(params, {k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        out = model(**{k: torch.as_tensor(v) for k, v in kw.items()}).logits
    err = float(np.abs(out.numpy()[VALID] - np.asarray(ref, np.float32)[VALID]).max())
    assert err < TOL, f"max |port - jax| = {err}"


GEN_IDS = np.array([[0, 0, 0, 5, 77, 140, 9, 33, 210, 6, 4],
                    [61, 18, 99, 250, 3, 3, 47, 128, 15, 90, 11]], np.int64)
GEN_MASK = (np.arange(11)[None, :] >= np.array([[3], [0]])).astype(np.int32)


def test_family_greedy_generate_matches_jax(family):
    """Left-padded prompts bucketed to 16 slots, 10 new tokens: the windows
    of 5 slide through the prompt and the decode steps."""
    _, jax_model, params, model = family
    kw = dict(max_new_tokens=10, prompt_pad_multiple=8)
    ref = np.asarray(jax_model.generate(params, input_ids=jnp.asarray(GEN_IDS),
                                        attention_mask=jnp.asarray(GEN_MASK), **kw))
    out = model.generate(torch.as_tensor(GEN_IDS), attention_mask=torch.as_tensor(GEN_MASK),
                         **kw)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_family_checkpoint_round_trip(family, tmp_path):
    """The JAX package's checkpoint through the port's AutoModelForCausalLM:
    a clean load report and the same weights; the port's save reads back the
    same. A tied model's file holds no lm_head."""
    model_type, jax_model, params, model = family
    jax_model.save_pretrained(str(tmp_path / "jax"), params=params)
    loaded = port.AutoModelForCausalLM.from_pretrained(tmp_path / "jax", dtype="float32",
                                                       device="cpu")
    report = loaded.load_report
    assert not report.missing_keys and not report.unexpected_keys, report
    assert type(loaded) is type(model)
    want = model.state_dict()
    assert loaded.state_dict().keys() == want.keys()
    for name, t in loaded.state_dict().items():
        assert torch.equal(t, want[name]), name
    loaded.save_pretrained(tmp_path / "port")
    saved = load_file(str(tmp_path / "port" / "model.safetensors"))
    written = load_file(str(tmp_path / "jax" / "model.safetensors"))
    assert saved.keys() == written.keys()
    for name, t in saved.items():
        assert torch.equal(t, written[name]), name
    tied = model.config.tie_word_embeddings
    assert ("lm_head.weight" in saved) == (not tied)
    again = port.AutoModelForCausalLM.from_pretrained(tmp_path / "port", device="cpu")
    assert again.config.model_type == model_type and not again.load_report.missing_keys
    with torch.no_grad():
        ids = torch.as_tensor(GEN_IDS[1:])
        assert torch.equal(again(ids).logits, model(ids).logits)


@pytest.mark.parametrize("family", CB_FAMILIES, indirect=True)
def test_family_continuous_batching_matches_static_generate(family):
    """Prompts of 3-12 tokens through the paged engine (4-token prefill
    chunks over pages of 4, windows of 5 across page boundaries) give the
    static-cache generate's greedy tokens, prompt by prompt (up to and with
    an EOS, where the engine stops)."""
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


GRAD_FAMILIES = ("gemma", "gemma2", "gemma3_text")


@pytest.mark.parametrize("family", GRAD_FAMILIES, indirect=True)
def test_family_loss_and_every_gradient_match_jax_value_and_grad(family):
    """The training path of the Gemma families (Gemma at head_dim 256, Gemma-2
    with its attention and final softcaps, Gemma-3 with its sliding and global
    layers; at the module's configs and weights): the loss of a right-padded
    batch (labels -100 on the pad, no position_ids, so the port's attention
    takes the flash route and its autograd.Function) and every parameter's
    gradient against jax.value_and_grad of the JAX family, float32, at
    tests/test_torch_trainer.py's tolerances (atol 2e-5, rtol 1e-4)."""
    _, jax_model, params, model = family
    rng = np.random.default_rng(7)
    lengths = (12, 8)
    ids = rng.integers(3, model.config.vocab_size, (len(lengths), 12))
    mask = (np.arange(12)[None, :] < np.array(lengths)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, ids, 0)
    batch = dict(input_ids=ids, attention_mask=mask, labels=np.where(mask == 1, ids, -100))
    loss_ref, grads_ref = jax.jit(jax.value_and_grad(
        lambda p: jax_model(p, **{k: jnp.asarray(v) for k, v in batch.items()}).loss))(params)
    model.zero_grad(set_to_none=True)
    loss = model(**{k: torch.as_tensor(v) for k, v in batch.items()}).loss
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_ref), atol=2e-5, rtol=1e-4)
    ref = port.params_from_jax(jax.tree.map(np.asarray, grads_ref))
    assert set(ref) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref[name].numpy(), atol=2e-5, rtol=1e-4,
                                   err_msg=name)
    model.zero_grad(set_to_none=True)


def test_embed_scale_is_a_float_rounded_to_the_compute_dtype():
    """Gemma's sqrt(hidden) is rounded to the compute dtype once, at init, and
    kept as a Python float: no forward makes or copies a tensor for it (a copy
    to the card would be a host sync inside the captured decode step)."""
    config = port.GemmaConfig(**_config("gemma"))
    model = port.GemmaForCausalLM(config, dtype=torch.bfloat16, device="cpu")
    scale = model.model.embed_scale()
    assert type(scale) is float
    assert scale == float(torch.tensor(128 ** 0.5, dtype=torch.bfloat16)) != 128 ** 0.5
    model.init_weights(0)
    ids = torch.tensor([[3, 9, 27]])
    want = (model.model.embed_tokens(ids).float() * scale).to(torch.bfloat16)
    assert torch.equal(model.model.embed(ids), want)


def test_flash_route_at_head_dim_96_needs_no_gradient():
    """K1, K4 and K5 all take head_dim 96, so the flash route at 96 does not
    depend on whether autograd records the call."""
    from transformers_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS, flash_supported

    q, k = torch.zeros(1, 4, 2, 96), torch.zeros(1, 4, 1, 96)
    assert 96 in KERNEL_HEAD_DIMS and flash_supported(q, k, k)
    assert flash_supported(q.requires_grad_(), k, k)
    with torch.no_grad():
        assert flash_supported(q, k, k)
    q80, k80 = torch.zeros(1, 4, 2, 80), torch.zeros(1, 4, 1, 80)
    assert not flash_supported(q80, k80, k80)
