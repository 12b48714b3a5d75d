"""Beam search in the port against the JAX package, on the CPU in float32.

A tiny Llama (vocab 128, hidden 48, 2 layers, head_dim 64, so the prefill
and the beam steps take the flash and fused decode wrappers, whose plain
versions run on CPU tensors), weights from a numpy seed carried across by
``params_from_jax``. Each case runs JAX ``build_beam_search_fn`` once
(module-scoped) and holds the port to it: sequences exactly, scores within
1e-5, through ``generate(num_beams=...)`` and through the port's
``build_beam_search_fn``. Batch 2 with one row left-padded; beams and new
tokens (2, 6) and (4, 8); ``length_penalty`` 1.0, 0.7 and 1.5;
``early_stopping`` False, True and "never"; each case's EOS fires, and one
case ends the search before ``max_new_tokens``, so the steps run after the
end must leave the buffers as they were. Also: top-k ties go to the lower
index as in ``lax.top_k`` (alone, and through a whole search whose model
has two equal lm_head rows), the JAX package's route order (a streamer with
``num_beams=2`` takes the streaming route), the refusal of the int8 cache,
``get_generation_mode`` and the cache reorder in place.

On the CPU the beam step runs as a Python loop over the same function the
card captures as a CUDA graph.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_llama import build_pair  # noqa: E402

import transformers_tpu_torch as port  # noqa: E402
from transformers_tpu.generation import GenerationConfig as JaxGenerationConfig  # noqa: E402
from transformers_tpu.generation.beam_search import \
    build_beam_search_fn as jax_beam_search_fn  # noqa: E402
from transformers_tpu_torch.generation import beam_search  # noqa: E402
from transformers_tpu_torch.generation.streamers import BaseStreamer  # noqa: E402
from transformers_tpu_torch.generation.utils import StaticDecode  # noqa: E402
from torch_port_testing import one_torch_thread  # noqa: E402,F401

TINY = dict(vocab_size=128, hidden_size=48, intermediate_size=96, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=64,
            max_position_embeddings=512, eos_token_id=2, pad_token_id=0)
PROMPT = np.array([[0, 0, 1, 5, 9, 3], [7, 2, 8, 4, 11, 12]], np.int64)
MASK = np.array([[0, 0, 1, 1, 1, 1], [1] * 6], np.int32)
BUCKET = 8  # prompt_pad_multiple
TIED = (116, 7)  # lm_head row 7 made equal to row 116, a token the search takes

CASES = {
    "beams2_new6_stop_true_lp0.7": dict(num_beams=2, max_new_tokens=6, num_return_sequences=2,
                                        length_penalty=0.7, early_stopping=True,
                                        eos_token_id=[44, 116]),
    "beams4_new8_stop_false": dict(num_beams=4, max_new_tokens=8, num_return_sequences=2,
                                   length_penalty=1.0, early_stopping=False,
                                   eos_token_id=[104, 116]),
    "beams4_new8_never_lp1.5": dict(num_beams=4, max_new_tokens=8, num_return_sequences=2,
                                    length_penalty=1.5, early_stopping="never",
                                    eos_token_id=[44, 116]),
}


@pytest.fixture(scope="module")
def pair():
    return build_pair(TINY, seed=0, std=0.3)


def _padded():
    pad = BUCKET - PROMPT.shape[1]
    return np.pad(PROMPT, ((0, 0), (pad, 0))), np.pad(MASK, ((0, 0), (pad, 0)))


def _fn_kwargs(kw):
    return dict(bucket=BUCKET, total_len=BUCKET + kw["max_new_tokens"],
                max_new=kw["max_new_tokens"], num_beams=kw["num_beams"],
                eos_ids=tuple(kw["eos_token_id"]), pad_id=0,
                length_penalty=kw["length_penalty"], early_stopping=kw["early_stopping"],
                num_return_sequences=kw["num_return_sequences"])


@pytest.fixture(scope="module")
def jax_fns(pair):
    """One compiled JAX beam-search function per case (params are an input,
    so the tied weights reuse their case's)."""
    jax_model = pair[0]
    return {name: jax_beam_search_fn(jax_model, cache_dtype=jnp.float32, **_fn_kwargs(kw))
            for name, kw in CASES.items()}


def _run_jax(fn, params):
    ids, mask = _padded()
    seqs, scores = fn(params, jnp.asarray(ids), jnp.asarray(mask))
    return np.asarray(seqs), np.asarray(scores)


def _run_port(model, kw):
    ids, mask = _padded()
    seqs, scores = beam_search.build_beam_search_fn(model, **_fn_kwargs(kw))(
        torch.as_tensor(ids), torch.as_tensor(mask))
    return seqs.numpy(), scores.numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_beam_search_matches_jax(pair, jax_fns, name):
    _, params, model = pair
    kw = CASES[name]
    seqs, scores = _run_jax(jax_fns[name], params)
    out = model.generate(torch.as_tensor(PROMPT), attention_mask=torch.as_tensor(MASK),
                         prompt_pad_multiple=BUCKET, **kw)
    np.testing.assert_array_equal(out.numpy(), seqs.reshape(-1, seqs.shape[-1]))
    assert isinstance(model._decode_program, beam_search.BeamSearch)

    p_seqs, p_scores = _run_port(model, kw)
    np.testing.assert_array_equal(p_seqs, seqs)
    np.testing.assert_allclose(p_scores, scores, rtol=0, atol=1e-5)
    # the EOS fired: a returned hypothesis ends with it
    gen = seqs[:, :, BUCKET:]
    assert np.isin(gen, kw["eos_token_id"]).any()
    program = model._decode_program
    if kw["early_stopping"] is True:
        # the search ended before max_new_tokens, and the steps run after its
        # end (one host read per EOS_CHECK_STEPS) changed nothing
        assert int(program.t) < kw["max_new_tokens"] == program.steps_run


def test_top_k_breaks_ties_to_the_lower_index():
    x = np.array([[0.5, -1e9, 2.0, 0.5, -1e9, 2.0, -0.25, 0.5, -1e9, 3.0],
                  [-1e9] * 10], np.float32)
    for k in (1, 3, 5, 8):
        ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
        v, i = beam_search.top_k(torch.as_tensor(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref_v))


def test_planted_tie_resolves_as_jax(pair, jax_fns):
    """Two lm_head rows equal: the two tokens tie in every candidate list, and
    the search keeps the lower one first, as the JAX package does."""
    _, params, model = pair
    kernel = np.asarray(params["lm_head"]["weight"]).copy()
    kernel[:, TIED[1]] = kernel[:, TIED[0]]
    tied_params = jax.tree.map(lambda x: x, params)
    tied_params["lm_head"]["weight"] = jnp.asarray(kernel)
    tied = port.LlamaForCausalLM(port.LlamaConfig(**TINY), dtype=torch.float32, device="cpu")
    tied.load_state_dict(model.state_dict())
    with torch.no_grad():
        tied.lm_head.weight[TIED[1]] = tied.lm_head.weight[TIED[0]]
    name = "beams4_new8_stop_false"
    seqs, scores = _run_jax(jax_fns[name], tied_params)
    assert np.isin(seqs[:, :, BUCKET:], TIED[1]).any()
    p_seqs, p_scores = _run_port(tied, CASES[name])
    np.testing.assert_array_equal(p_seqs, seqs)
    np.testing.assert_allclose(p_scores, scores, rtol=0, atol=1e-5)


class _Collect(BaseStreamer):
    def __init__(self):
        self.chunks = []

    def put(self, value):
        self.chunks.append(value)

    def end(self):
        pass


def test_streamer_takes_the_streaming_route_before_beams(pair):
    """The JAX package's order: a streamer (or stopping criteria, or stop
    strings) wins over ``num_beams > 1``."""
    model = pair[2]
    kw = dict(attention_mask=torch.as_tensor(MASK), prompt_pad_multiple=BUCKET,
              max_new_tokens=5, eos_token_id=[])
    streamed = model.generate(torch.as_tensor(PROMPT), num_beams=2, streamer=_Collect(), **kw)
    assert isinstance(model._decode_program, StaticDecode)
    assert torch.equal(streamed, model.generate(torch.as_tensor(PROMPT), **kw))


def test_beam_search_refuses_the_int8_cache(pair):
    with pytest.raises(ValueError, match="static cache"):
        pair[2].generate(torch.as_tensor(PROMPT), num_beams=2, max_new_tokens=3,
                         cache_implementation="quantized")


@pytest.mark.parametrize("kw", [{}, dict(do_sample=True), dict(num_beams=3),
                                dict(num_beams=3, do_sample=True)],
                         ids=["greedy", "sample", "beam", "beam_sample"])
def test_generation_mode_matches_jax(kw):
    for assistant in (None, object()):
        assert (port.GenerationConfig(**kw).get_generation_mode(assistant)
                == JaxGenerationConfig(**kw).get_generation_mode(assistant))


def test_cache_reorder_writes_back_in_place():
    cache = port.LlamaForCausalLM(port.LlamaConfig(**TINY), dtype=torch.float32,
                                  device="cpu").init_cache(4, 8)
    gen = torch.Generator().manual_seed(0)
    for buf in cache.keys + cache.values:
        buf.copy_(torch.randn(buf.shape, generator=gen))
    before = [buf.clone() for buf in cache.keys + cache.values]
    ptrs = [buf.data_ptr() for buf in cache.keys + cache.values]
    idx = torch.tensor([2, 2, 0, 3])
    cache.reorder_(idx)
    for buf, old, ptr in zip(cache.keys + cache.values, before, ptrs):
        assert buf.data_ptr() == ptr
        assert torch.equal(buf, old.index_select(0, idx))
