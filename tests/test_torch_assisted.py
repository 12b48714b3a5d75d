"""Assisted (speculative) decoding in the port against the JAX package, on the
CPU in float32: the cases of the JAX package's
tests/generation/test_assisted.py, each held to JAX ``assisted_generate``
(or its ``generate(assistant_model=...)`` route) token for token.

Target: a tiny Llama (vocab 128, hidden 48, 2 layers, head_dim 64); draft:
hidden 32, 1 layer; weights from numpy seeds carried across by
``params_from_jax``. Greedy verification with a draft at 2 and 5 proposals
a round, the target as its own draft (every proposal accepted), the public
``generate`` route, prompt lookup, and speculative sampling at seeds 0-2
(the same numpy draws from the same logits). Greedy outputs also equal the
port's plain greedy ``generate``.

JAX's decoders jit one forward per window width in each new decoder object;
the cases here share those programs (by model and width), so each width
compiles once per model in this module.
"""

import logging
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_beam_search import TINY  # noqa: E402
from test_torch_llama import build_pair  # noqa: E402

from transformers_tpu.generation import candidate_generator as jax_cg  # noqa: E402
from transformers_tpu_torch.generation import candidate_generator  # noqa: E402
from torch_port_testing import one_torch_thread  # noqa: E402,F401

TARGET = dict(TINY, num_hidden_layers=2)
DRAFT = dict(TINY, hidden_size=32, intermediate_size=64, num_hidden_layers=1)
IDS = np.array([[1, 5, 9, 3]], np.int64)
LOOKUP_IDS = np.array([[4, 7, 9, 4, 7, 9, 4, 7]], np.int64)
MAX_LEN = 64  # what generate() picks for these prompts


@pytest.fixture(scope="module")
def models():
    return build_pair(TARGET, seed=0, std=0.3), build_pair(DRAFT, seed=1, std=0.3)


@pytest.fixture(scope="module", autouse=True)
def shared_jax_programs():
    compiled = {}
    patch = pytest.MonkeyPatch()
    for cls in (jax_cg.SpeculativeDecoder, jax_cg.AssistedCandidateGenerator):
        def shared(self, *key, _fn=cls._fn):
            name = (id(self.model), key[-1])
            if name not in compiled:
                compiled[name] = _fn(self, *key)
            return compiled[name]

        patch.setattr(cls, "_fn", shared)
    yield
    patch.undo()


def _jax(models, ids, draft=True, **kw):
    (jt, jp, _), (jd, jdp, _) = models
    if draft is True:
        draft_kw = dict(assistant_model=jd, draft_params=jdp)
    elif draft == "self":
        draft_kw = dict(assistant_model=jt, draft_params=jp)
    else:
        draft_kw = {}
    return jax_cg.assisted_generate(jt, input_ids=ids, params=jp, max_len=MAX_LEN,
                                    eos_token_id=-1, **draft_kw, **kw)


def _greedy(model, ids, new):
    return model.generate(torch.as_tensor(ids), max_new_tokens=new,
                          prompt_pad_multiple=ids.shape[1], eos_token_id=-1).numpy()


@pytest.mark.parametrize("gamma", [2, 5])
def test_assisted_matches_jax_and_greedy(models, gamma):
    (_, _, target), (_, _, draft) = models
    out = candidate_generator.assisted_generate(
        target, draft, IDS, max_new_tokens=16, num_assistant_tokens=gamma, eos_token_id=-1,
        max_len=MAX_LEN)
    ref = _jax(models, IDS, max_new_tokens=16, num_assistant_tokens=gamma)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _greedy(target, IDS, 16))


def test_self_assisted_accepts_everything(models, monkeypatch):
    """The target as its own draft: every proposal accepted, the output still
    the greedy one."""
    (_, _, target), _ = models
    seen = []
    monkeypatch.setattr(candidate_generator.AssistedCandidateGenerator, "observe",
                        lambda self, n_accepted, n_proposed: seen.append((n_accepted,
                                                                          n_proposed)))
    out = candidate_generator.assisted_generate(target, target, IDS[:, ::-1].copy(),
                                                max_new_tokens=12, num_assistant_tokens=4,
                                                eos_token_id=-1, max_len=MAX_LEN)
    ref = _jax(models, IDS[:, ::-1].copy(), draft="self", max_new_tokens=12,
               num_assistant_tokens=4)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _greedy(target, IDS[:, ::-1].copy(), 12))
    assert seen and all(a == n for a, n in seen)


def test_public_api_routes_the_assistant(models, caplog):
    """``generate(assistant_model=...)`` takes the assisted route, as the JAX
    package's ``generate`` does; no kwarg is left over."""
    (jt, jp, target), (jd, jdp, draft) = models
    with caplog.at_level(logging.WARNING):
        out = target.generate(torch.as_tensor(IDS), max_new_tokens=16, assistant_model=draft,
                              eos_token_id=-1).numpy()
    assert "ignoring" not in caplog.text
    ref = np.asarray(jt.generate(jp, input_ids=jnp.asarray(IDS), max_new_tokens=16,
                                 assistant_model=jd, assistant_params=jdp, eos_token_id=-1))
    np.testing.assert_array_equal(out, ref)


def test_prompt_lookup_matches_jax_and_greedy(models):
    (jt, jp, target), _ = models
    out = target.generate(torch.as_tensor(LOOKUP_IDS), max_new_tokens=12,
                          prompt_lookup_num_tokens=5, eos_token_id=-1).numpy()
    ref = np.asarray(jt.generate(jp, input_ids=jnp.asarray(LOOKUP_IDS), max_new_tokens=12,
                                 prompt_lookup_num_tokens=5, eos_token_id=-1))
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, _greedy(target, LOOKUP_IDS, 12))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_speculative_sampling_matches_jax(models, seed):
    """Sampling at a seed: the port seeds its numpy draws with the generator's
    ``initial_seed()`` as the JAX package does with its key, so the same
    logits give the same tokens."""
    (jt, jp, target), (jd, jdp, draft) = models
    out = target.generate(torch.as_tensor(IDS), max_new_tokens=12, assistant_model=draft,
                          do_sample=True, temperature=1.3, eos_token_id=-1,
                          generator=torch.Generator().manual_seed(seed)).numpy()
    ref = np.asarray(jt.generate(jp, input_ids=jnp.asarray(IDS), max_new_tokens=12,
                                 assistant_model=jd, assistant_params=jdp, do_sample=True,
                                 temperature=1.3, eos_token_id=-1,
                                 prng_key=jax.random.key(seed)))
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, _greedy(target, IDS, 12))


def test_assisted_refuses_batches(models):
    (_, _, target), (_, _, draft) = models
    with pytest.raises(ValueError, match="batch size 1"):
        target.generate(torch.as_tensor(np.repeat(IDS, 2, 0)), max_new_tokens=4,
                        assistant_model=draft)
