"""The port's generation surface against the JAX package, on the CPU.

- Every logits processor ported to ``transformers_tpu_torch.generation.logits_process``
  against its JAX counterpart on the same seeded logits and decode state, in
  float32: values to 1e-6, and the filtered entries (-inf or the processors'
  large finite NEG_INF) exactly.
- Greedy ``generate()`` with each processor JAX's ``_get_logits_processors``
  builds, token for token against JAX ``generate()`` (the tiny Llama pair of
  ``test_torch_llama.py``; weights carried by ``params_from_jax``).
- The streaming route (streamer, stop strings, ``MaxTimeCriteria``,
  ``EosTokenCriteria``) against the plain route and against JAX's streaming
  route, as JAX's tests/generation/test_streaming.py holds them.
- ``decode_pad_multiple``: outputs equal the uncapped ones, one kept decode
  program for both lengths.
- ``cache_implementation="quantized"``: the int8 KV cache, its ids and every
  step's logits against JAX ``generate`` and its int8 cache (2e-5).

On the CPU the decode step runs as a Python loop over the same step function
the card captures as a CUDA graph.
"""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_llama import _build, jax_forward  # noqa: E402

from transformers_tpu.generation import logits_process as jax_lp  # noqa: E402
from transformers_tpu.generation import stopping_criteria as jax_sc  # noqa: E402
from transformers_tpu.generation.streamers import BaseStreamer as JaxBaseStreamer  # noqa: E402
from transformers_tpu_torch.generation import logits_process as port_lp  # noqa: E402
from transformers_tpu_torch.generation import stopping_criteria as port_sc  # noqa: E402
from transformers_tpu_torch.generation import streamers as port_streamers  # noqa: E402
from transformers_tpu_torch.ops import cuda_build  # noqa: E402

TOL = 1e-6
B, T, V = 3, 24, 64


def _state(seed=0, pos=17, gen_count=5):
    """A decode state: ids from a small alphabet (so n-grams repeat), row 1
    left-padded by 4 slots, nothing valid from ``pos`` on."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 6, size=(B, T)).astype(np.int64)
    mask = np.ones((B, T), np.int32)
    mask[1, :4] = 0
    ids[1, :4] = 0
    mask[:, pos:] = 0
    ids[:, pos:] = 0
    return ids, mask, pos, gen_count


def _jax_state(ids, mask, pos, gen_count):
    return {"ids": jnp.asarray(ids, jnp.int32), "mask": jnp.asarray(mask),
            "pos": jnp.asarray(pos, jnp.int32), "gen_count": jnp.asarray(gen_count, jnp.int32)}


def _port_state(ids, mask, pos, gen_count):
    return {"ids": torch.as_tensor(ids), "mask": torch.as_tensor(mask),
            "pos": torch.tensor(pos, dtype=torch.int64),
            "gen_count": torch.tensor(gen_count, dtype=torch.int64)}


def _uncond(state):
    return jnp.asarray(np.random.default_rng(9).standard_normal((B, V)), jnp.float32)


def _uncond_port(state):
    return torch.as_tensor(np.random.default_rng(9).standard_normal((B, V)).astype(np.float32))


def _allowed(batch_id, ids):
    return [int(ids[-1]) % V, (batch_id * 7) % V, 63]


# name: (JAX processor, port processor, state kwargs)
CASES = {
    "min_p": (lambda m: m.MinPLogitsWarper(0.05), {}),
    "repetition_penalty": (lambda m: m.RepetitionPenaltyLogitsProcessor(1.7), {}),
    "no_repeat_ngram_1": (lambda m: m.NoRepeatNGramLogitsProcessor(1), {}),
    "no_repeat_ngram_2": (lambda m: m.NoRepeatNGramLogitsProcessor(2), {}),
    "no_repeat_ngram_3": (lambda m: m.NoRepeatNGramLogitsProcessor(3), {}),
    "no_repeat_ngram_3_first_slots": (lambda m: m.NoRepeatNGramLogitsProcessor(3),
                                      dict(pos=1, gen_count=0)),
    "min_new_tokens_blocks": (lambda m: m.MinNewTokensLengthLogitsProcessor(8, [2, 5]), {}),
    "min_new_tokens_done": (lambda m: m.MinNewTokensLengthLogitsProcessor(3, [2, 5]), {}),
    "suppress_tokens": (lambda m: m.SuppressTokensLogitsProcessor([0, 7, 63]), {}),
    "suppress_at_begin": (lambda m: m.SuppressTokensAtBeginLogitsProcessor([1, 9]),
                          dict(gen_count=0)),
    "suppress_at_begin_later": (lambda m: m.SuppressTokensAtBeginLogitsProcessor([1, 9]), {}),
    "forced_bos": (lambda m: m.ForcedBOSTokenLogitsProcessor(3), dict(gen_count=0)),
    "forced_bos_later": (lambda m: m.ForcedBOSTokenLogitsProcessor(3), {}),
    "forced_eos": (lambda m: m.ForcedEOSTokenLogitsProcessor(6, 2), {}),
    "forced_eos_early": (lambda m: m.ForcedEOSTokenLogitsProcessor(9, 2), {}),
    "typical": (lambda m: m.TypicalLogitsWarper(0.8), {}),
    "epsilon": (lambda m: m.EpsilonLogitsWarper(0.02, min_tokens_to_keep=3), {}),
    "eta": (lambda m: m.EtaLogitsWarper(0.02), {}),
    "no_bad_words": (lambda m: m.NoBadWordsLogitsProcessor([[7], [3, 1], [2, 4, 5]]), {}),
    "logit_normalization": (lambda m: m.LogitNormalization(), {}),
    "exponential_decay": (lambda m: m.ExponentialDecayLengthPenalty((2, 1.5), [2, 5]), {}),
    "min_length": (lambda m: m.MinLengthLogitsProcessor(30, [2, 5], prompt_len=20), {}),
    "min_length_reached": (lambda m: m.MinLengthLogitsProcessor(22, 2, prompt_len=20), {}),
    "inf_nan_remove": (lambda m: m.InfNanRemoveLogitsProcessor(), {}),
    "sequence_bias": (lambda m: m.SequenceBiasLogitsProcessor(
        {(4,): 2.5, (0, 1): -3.0, (2, 4, 5): 1.25}), {}),
    "cfg": (lambda m: m.ClassifierFreeGuidanceLogitsProcessor(1.5), {}),
    "cfg_unbatched": (lambda m: m.UnbatchedClassifierFreeGuidanceLogitsProcessor(
        1.5, _uncond if m is jax_lp else _uncond_port), {}),
    "prefix_constrained": (lambda m: m.PrefixConstrainedLogitsProcessor(_allowed), {}),
}


def _filtered(x):
    return np.isneginf(x) | (x <= port_lp.NEG_INF / 2)


@pytest.mark.parametrize("name", list(CASES))
def test_processor_matches_jax(name):
    make, state_kw = CASES[name]
    ids, mask, pos, gen_count = _state(**state_kw)
    logits = np.random.default_rng(1).standard_normal((B, V)).astype(np.float32) * 3
    if name == "inf_nan_remove":
        logits[0, 3], logits[1, 5], logits[2, 8] = np.inf, -np.inf, np.nan
    if name == "cfg":
        logits = np.concatenate([logits, logits[::-1] * 0.5])
    ref = np.asarray(make(jax_lp)(jnp.asarray(logits), _jax_state(ids, mask, pos, gen_count)))
    out = make(port_lp)(torch.as_tensor(logits), _port_state(ids, mask, pos, gen_count)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_array_equal(_filtered(out), _filtered(ref))
    keep = ~_filtered(ref)
    np.testing.assert_allclose(out[keep], ref[keep], rtol=TOL, atol=TOL)


def test_repetition_and_ngram_masks_are_not_one_hots():
    """The port's n-gram and repetition masks come from a [B, V + 1] scatter:
    at the full Llama-3 vocabulary their memory is B * V bytes, not B * T * V."""
    ids, mask, pos, gen_count = _state()
    state = _port_state(ids, mask, pos, gen_count)
    seen = port_lp._seen_mask(state["ids"], state["mask"] != 0, 128256)
    assert seen.shape == (B, 128256) and seen.dtype == torch.bool
    want = np.zeros((B, 128256), bool)
    for r in range(B):
        want[r, ids[r][mask[r] != 0]] = True
    np.testing.assert_array_equal(seen.numpy(), want)


@pytest.fixture(scope="module")
def pair():
    return _build("base", seed=11)


PROMPT = np.array([[0, 0, 0, 5, 77, 140, 9, 33, 210, 6, 4],
                   [61, 18, 99, 250, 3, 3, 47, 128, 15, 90, 11]], np.int64)
PROMPT_MASK = (np.arange(11)[None, :] >= np.array([[3], [0]])).astype(np.int32)
GEN = dict(max_new_tokens=10, prompt_pad_multiple=8)


def _jax_and_port(pair, **kw):
    jax_model, params, model = pair
    kw = dict(GEN, **kw)
    jkw = {k: v for k, v in kw.items() if k != "stopping_criteria"}
    pkw = dict(jkw)
    if "stopping_criteria" in kw:
        jkw["stopping_criteria"], pkw["stopping_criteria"] = kw["stopping_criteria"]
    ref = np.asarray(jax_model.generate(params, input_ids=jnp.asarray(PROMPT),
                                        attention_mask=jnp.asarray(PROMPT_MASK), **jkw))
    out = model.generate(torch.as_tensor(PROMPT), attention_mask=torch.as_tensor(PROMPT_MASK),
                         **pkw).numpy()
    return out, ref


# one case per processor JAX's ``_get_logits_processors`` builds; min_p needs
# do_sample, and at min_p 1.0 it keeps the argmax only (top_k=1 would hide it)
GREEDY_PROCESSORS = {
    "repetition_penalty": dict(repetition_penalty=1.8),
    "no_repeat_ngram_size": dict(no_repeat_ngram_size=1),
    "min_new_tokens": dict(min_new_tokens=6, eos_token_id=[209, 53]),
    "suppress_tokens": dict(suppress_tokens=[209, 50, 7]),
    "begin_suppress_tokens": dict(begin_suppress_tokens=[50, 224, 7]),
    "min_p": dict(do_sample=True, min_p=1.0, top_k=0),
}


@pytest.mark.parametrize("name", list(GREEDY_PROCESSORS))
def test_greedy_generate_with_processor_matches_jax(pair, name):
    out, ref = _jax_and_port(pair, **GREEDY_PROCESSORS[name])
    assert out.shape == ref.shape == (2, 16 + 10)
    np.testing.assert_array_equal(out, ref)
    if name != "min_p":  # the processor changed what greedy decoding picks
        eos = {k: v for k, v in GREEDY_PROCESSORS[name].items() if k == "eos_token_id"}
        plain = pair[2].generate(torch.as_tensor(PROMPT),
                                 attention_mask=torch.as_tensor(PROMPT_MASK), **GEN, **eos)
        assert not np.array_equal(out, plain.numpy())


class Collect(port_streamers.BaseStreamer, JaxBaseStreamer):
    def __init__(self):
        self.chunks = []
        self.ended = False

    def put(self, value):
        self.chunks.append(np.asarray(value))

    def end(self):
        self.ended = True


class Letters:
    """A duck-typed tokenizer: one letter per token id."""

    def decode(self, ids, **kw):
        return "".join(chr(97 + (int(t) % 26)) for t in ids)


@pytest.mark.parametrize("eos", [None, [209, 53]], ids=["no_eos", "eos_hit"])
def test_streaming_route_matches_plain_route_and_jax(pair, eos):
    """The streamer gets the padded prompt, then one [B, 1] chunk per
    generated token; the tokens equal the plain route's and JAX's streaming
    route's. With ``eos_hit``, one row finishes early (pad after it)."""
    kw = {} if eos is None else dict(eos_token_id=eos)
    _, _, model = pair
    plain = model.generate(torch.as_tensor(PROMPT), attention_mask=torch.as_tensor(PROMPT_MASK),
                           **GEN, **kw).numpy()
    streamer, jax_streamer = Collect(), Collect()
    jax_model, params, _ = pair
    ref = np.asarray(jax_model.generate(params, input_ids=jnp.asarray(PROMPT),
                                        attention_mask=jnp.asarray(PROMPT_MASK), **GEN, **kw,
                                        streamer=jax_streamer))
    out = model.generate(torch.as_tensor(PROMPT), attention_mask=torch.as_tensor(PROMPT_MASK),
                         **GEN, **kw, streamer=streamer).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, plain[:, :out.shape[1]])
    assert streamer.ended and len(streamer.chunks) == 1 + out.shape[1] - 16
    np.testing.assert_array_equal(streamer.chunks[0], out[:, :16])
    np.testing.assert_array_equal(np.concatenate(streamer.chunks[1:], axis=1), out[:, 16:])
    for a, b in zip(streamer.chunks, jax_streamer.chunks):
        np.testing.assert_array_equal(a, b)
    if eos is not None:
        assert np.isin(out[:, 16:], eos).any(axis=1).sum() == 1


def test_stop_strings_match_jax(pair):
    """Stop strings from the text of each row's own generated tokens (row 0's
    third and fourth, row 1's second and third): each row stops where its
    string ends, writes pad after that, and the loop ends with the later one."""
    _, _, model = pair
    full = model.generate(torch.as_tensor(PROMPT), attention_mask=torch.as_tensor(PROMPT_MASK),
                          **GEN).numpy()
    stops = [Letters().decode(full[0, 18:20]), Letters().decode(full[1, 17:19])]
    out, ref = _jax_and_port(pair, stop_strings=stops, tokenizer=Letters())
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (2, 20)
    np.testing.assert_array_equal(out[0], full[0, :20])
    np.testing.assert_array_equal(out[1, :19], full[1, :19])
    assert out[1, 19] == 0
    with pytest.raises(ValueError, match="tokenizer"):
        model.generate(torch.as_tensor(PROMPT), stop_strings=["x"], **GEN)


def test_max_time_and_eos_criteria_match_jax(pair):
    """MaxTimeCriteria at 0 s stops after the first token; EosTokenCriteria on
    a token row 1 generates stops that row and runs the other to the end."""
    out, ref = _jax_and_port(pair, stopping_criteria=(
        [jax_sc.MaxTimeCriteria(max_time=0.0)], [port_sc.MaxTimeCriteria(max_time=0.0)]))
    np.testing.assert_array_equal(out, ref)
    assert out.shape == (2, 17)
    _, _, model = pair
    full = model.generate(torch.as_tensor(PROMPT), attention_mask=torch.as_tensor(PROMPT_MASK),
                          **GEN).numpy()
    eos = int(full[1, 19])
    out, ref = _jax_and_port(pair, stopping_criteria=(
        [jax_sc.EosTokenCriteria(eos)], [port_sc.EosTokenCriteria(eos)]))
    np.testing.assert_array_equal(out, ref)
    assert (out[1, 20:] == 0).all() and out.shape[1] > 20


def test_criteria_lists_match_jax():
    ids = np.array([[4, 5, 6, 2], [1, 2, 3, 4]], np.int64)
    for j, p in ((jax_sc.MaxLengthCriteria(4), port_sc.MaxLengthCriteria(4)),
                 (jax_sc.MaxLengthCriteria(5), port_sc.MaxLengthCriteria(5)),
                 (jax_sc.EosTokenCriteria([2, 9]), port_sc.EosTokenCriteria([2, 9])),
                 (jax_sc.StopStringCriteria(Letters(), ["gc", "zz"]),
                  port_sc.StopStringCriteria(Letters(), ["gc", "zz"]))):
        np.testing.assert_array_equal(port_sc.StoppingCriteriaList([p])(ids),
                                      jax_sc.StoppingCriteriaList([j])(ids))


def test_text_streamers_decode_as_jax():
    from transformers_tpu.generation import streamers as jax_streamers

    port_it = port_streamers.TextIteratorStreamer(Letters(), skip_prompt=True)
    jax_it = jax_streamers.TextIteratorStreamer(Letters(), skip_prompt=True)
    for s in (port_it, jax_it):
        s.put(np.array([[1, 2, 3]]))
        for t in (4, 5, 6):
            s.put(np.array([[t]]))
        s.end()
    assert list(port_it) == list(jax_it) == ["e", "f", "g", ""]


def test_decode_pad_multiple_keeps_one_program(pair):
    """At decode_pad_multiple 16, max_new_tokens 6 and 12 give the uncapped
    outputs and share one decode program (cache and step sized for 16)."""
    _, _, model = pair
    ids = torch.as_tensor(PROMPT[:1, 3:])
    kw = dict(prompt_pad_multiple=4)
    plain = {n: model.generate(ids, max_new_tokens=n, **kw) for n in (6, 12)}
    capped, programs = {}, []
    for n in (6, 12):
        capped[n] = model.generate(ids, max_new_tokens=n, decode_pad_multiple=16, **kw)
        programs.append(model._decode_program)
    assert programs[0] is programs[1]
    assert programs[0].cache.max_len == 8 + 16
    for n in (6, 12):
        assert capped[n].shape == (1, 8 + n)
        assert torch.equal(capped[n], plain[n])


def test_read_back_counts_the_loops_host_reads(pair):
    """generate reads ``finished`` back once per EOS_CHECK_STEPS steps, and only
    when there are EOS ids; the streaming route once per token."""
    from transformers_tpu_torch.generation.utils import EOS_CHECK_STEPS

    _, _, model = pair
    ids = torch.as_tensor(PROMPT)
    steps = 2 * EOS_CHECK_STEPS + 3
    for eos, reads in (([], 0), ([300], 2)):  # 300 is outside the vocabulary: never hit
        before = cuda_build.read_back.reads
        model.generate(ids, max_new_tokens=steps + 1, prompt_pad_multiple=8, eos_token_id=eos)
        assert cuda_build.read_back.reads - before == reads
    before = cuda_build.read_back.reads
    model.generate(ids, max_new_tokens=5, prompt_pad_multiple=8, streamer=Collect())
    assert cuda_build.read_back.reads - before == 5


def test_quantized_cache_generate_matches_jax(pair, monkeypatch):
    """``cache_implementation="quantized"`` gives the int8 KV cache's result, as
    in the JAX package: greedy ids equal, and the logits each step of
    ``generate`` draws from (the prefill's, then every decode step's) below
    2e-5 from the JAX package's, teacher-forced through its int8 cache. The
    port used to accept the value and build its static cache instead, so the
    same call gave other logits than the JAX package's."""
    from transformers_tpu_torch.generation.utils import StaticDecode

    jax_model, params, model = pair
    drawn = []
    draw = StaticDecode.draw

    def record(self, logits, state, generator):
        drawn.append(logits.float().clone())
        return draw(self, logits, state, generator)

    monkeypatch.setattr(StaticDecode, "draw", record)
    out, ref = _jax_and_port(pair, cache_implementation="quantized", eos_token_id=[])
    np.testing.assert_array_equal(out, ref)

    new, bucket = GEN["max_new_tokens"], out.shape[1] - GEN["max_new_tokens"]
    pad = bucket - PROMPT.shape[1]
    ids = np.pad(PROMPT, ((0, 0), (pad, 0)))
    mask = np.zeros((2, bucket + new), np.int32)
    mask[:, pad:bucket] = PROMPT_MASK
    pos = np.maximum(np.cumsum(mask[:, :bucket], -1) - 1, 0)
    forward = jax_forward(jax_model)
    jcache = jax_model.init_cache(2, bucket + new, dtype=jnp.float32, implementation="quantized")
    logits, jcache = forward(params, dict(input_ids=jnp.asarray(ids),
                                          attention_mask=jnp.asarray(mask),
                                          position_ids=jnp.asarray(pos)), jcache)
    assert len(drawn) == new
    for g in range(new):
        err = float(np.abs(drawn[g].numpy() - np.asarray(logits[:, -1])).max())
        assert err < 2e-5, f"step {g}: max |port - jax| = {err}"
        slot = bucket + g
        mask[:, slot] = 1
        logits, jcache = forward(params, dict(input_ids=jnp.asarray(out[:, slot:slot + 1]),
                                              attention_mask=jnp.asarray(mask),
                                              position_ids=jnp.asarray(pos[:, -1:] + g + 1)),
                                 jcache, jnp.asarray(slot, jnp.int32))
    cache = model._decode_program.cache
    assert type(cache).__name__ == "QuantizedKVCache" and cache.keys[0].dtype == torch.int8
