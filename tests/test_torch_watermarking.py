"""Watermarking and the Hamming diversity processor in the port against the JAX
package, on the CPU: the cases of the JAX package's
tests/generation/test_synthid.py and test_logits_processors.py's watermark
test.

- Green list: masks bit for bit at the Llama-3 vocabulary for previous
  tokens up to 2**32 - 1 (the hash is uint32 arithmetic, run here in int64),
  the biased logits exactly, the detector's counts exactly and z within
  1e-6, and a greedy roll-out under the bias equal to JAX's, detected.
- SynthID: g-values bit for bit, five processor steps within 1e-5, the
  repeated-context bypass, and detection of a watermarked roll-out, every
  number against JAX's.
- ``HammingDiversityLogitsProcessor`` within 1e-6.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from transformers_tpu.generation import logits_process as jax_lp  # noqa: E402
from transformers_tpu.generation import watermarking as jax_wm  # noqa: E402
from transformers_tpu_torch.generation import logits_process as port_lp  # noqa: E402
from transformers_tpu_torch.generation import watermarking as port_wm  # noqa: E402
from torch_port_testing import one_torch_thread  # noqa: E402,F401

SYNTHID = dict(ngram_len=5, keys=[654, 400, 836, 123, 340, 443, 597, 160],
               sampling_table_size=2**16, sampling_table_seed=0, context_history_size=4)
# previous tokens: small ids, a Llama-3 id, and ids at and past 2**31
PREV = np.array([0, 1, 2, 128255, 2**31 - 1, 2**31, 3_000_000_000, 2**32 - 1], np.int64)


def test_greenlist_mask_matches_jax():
    jax_proc = jax_wm.WatermarkLogitsProcessor(128256)
    port_proc = port_wm.WatermarkLogitsProcessor(128256)
    ref = np.asarray(jax_proc.greenlist_mask(jnp.asarray(PREV.astype(np.uint32))))
    mask = port_proc.greenlist_mask(torch.as_tensor(PREV)).numpy()
    np.testing.assert_array_equal(mask, ref)
    assert 0.24 < mask.mean() < 0.26


@pytest.mark.parametrize("pos", [0, 1, 5])
def test_watermark_processor_matches_jax(pos):
    rng = np.random.default_rng(pos)
    vocab = 64
    ids = rng.integers(0, vocab, size=(3, 8))
    logits = rng.standard_normal((3, vocab)).astype(np.float32)
    jax_proc = jax_wm.WatermarkLogitsProcessor(vocab, bias=5.0)
    port_proc = port_wm.WatermarkLogitsProcessor(vocab, bias=5.0)
    ref = np.asarray(jax_proc(jnp.asarray(logits), {"ids": jnp.asarray(ids, jnp.int32),
                                                    "pos": jnp.asarray(pos, jnp.int32)}))
    out = port_proc(torch.as_tensor(logits), {"ids": torch.as_tensor(ids),
                                              "pos": torch.tensor(pos)}).numpy()
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, logits)


def test_watermark_bias_and_detection_match_jax():
    """JAX's test_watermark_bias_and_detection through both packages: the same
    greedy roll-out under the green bias, and the same detection."""
    vocab = 64
    procs = (jax_wm.WatermarkLogitsProcessor(vocab, greenlist_ratio=0.25, bias=5.0),
             port_wm.WatermarkLogitsProcessor(vocab, greenlist_ratio=0.25, bias=5.0))
    jax_step = jax.jit(lambda logits, ids, pos: procs[0](logits, {"ids": ids, "pos": pos}))
    rng = np.random.default_rng(0)
    seqs = ([5], [5])
    for _ in range(60):
        logits = rng.normal(size=(1, vocab)).astype(np.float32)
        for seq, is_port in zip(seqs, (False, True)):
            ids = [seq + [0] * (72 - len(seq))]  # one shape: JAX compiles its step once
            if is_port:
                biased = procs[1](torch.as_tensor(logits), {"ids": torch.as_tensor(ids),
                                                            "pos": torch.tensor(len(seq))}).numpy()
            else:
                biased = np.asarray(jax_step(jnp.asarray(logits), jnp.asarray(ids, jnp.int32),
                                             jnp.asarray(len(seq), jnp.int32)))
            seq.append(int(np.argmax(biased[0])))
    assert seqs[0] == seqs[1]
    unmarked = rng.integers(0, vocab, size=len(seqs[0]))
    for seq in (np.asarray(seqs[0]), unmarked):
        ref = jax_wm.WatermarkDetector(procs[0]).score(seq)
        got = port_wm.WatermarkDetector(procs[1]).score(torch.as_tensor(seq))
        np.testing.assert_array_equal(got["num_green"].numpy(), ref["num_green"])
        np.testing.assert_allclose(got["z_score"].numpy(), ref["z_score"], rtol=1e-6)
        np.testing.assert_array_equal(got["prediction"].numpy(), ref["prediction"])
    assert port_wm.WatermarkDetector(procs[1]).score(torch.as_tensor(seqs[0]))["prediction"][0]


def test_synthid_g_values_match_jax():
    ids = np.random.default_rng(0).integers(0, 1000, size=(3, 20))
    ref = jax_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID).compute_g_values(ids)
    port_proc = port_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID)
    np.testing.assert_array_equal(port_proc.compute_g_values(torch.as_tensor(ids)).numpy(), ref)
    np.testing.assert_array_equal(port_proc.sampling_table.numpy(),
                                  jax_wm.SynthIDTextWatermarkLogitsProcessor(
                                      **SYNTHID).sampling_table)


def test_synthid_step_scores_match_jax():
    ours = port_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID)
    ref = jax_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID)
    rng = np.random.default_rng(1)
    vocab = 50
    ids = rng.integers(0, vocab, size=(2, 6))
    for step in range(5):
        scores = rng.normal(size=(2, vocab)).astype(np.float32)
        cur = np.concatenate([ids, rng.integers(0, vocab, size=(2, step))], axis=1)
        out = ours(torch.as_tensor(cur), torch.as_tensor(scores)).numpy()
        np.testing.assert_allclose(out, ref(cur, scores), rtol=0, atol=1e-5)


def test_synthid_repeated_context_bypass():
    """The same token fed repeatedly: once the context hash repeats, the raw
    scores pass through, as in the JAX package."""
    ours = port_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID)
    ref = jax_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID)
    scores = np.random.default_rng(2).normal(size=(1, 30)).astype(np.float32)
    outs = []
    for step in range(7):
        cur = np.concatenate([np.ones((1, 6), np.int64), np.ones((1, step), np.int64)], axis=1)
        outs.append(ours(torch.as_tensor(cur), torch.as_tensor(scores)).numpy())
        np.testing.assert_allclose(outs[-1], ref(cur, scores), rtol=0, atol=1e-5)
    assert not np.allclose(outs[0], scores)
    np.testing.assert_array_equal(outs[-1], scores)


def test_synthid_detection_matches_jax():
    rng = np.random.default_rng(3)
    vocab = 200
    ids_wm = list(rng.integers(0, vocab, size=4))
    ids_raw = list(ids_wm)
    ours = port_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID)
    ref = jax_wm.SynthIDTextWatermarkLogitsProcessor(**SYNTHID)
    for _ in range(60):
        logits = rng.normal(scale=0.5, size=(1, vocab)).astype(np.float32)
        wm = ours(torch.as_tensor([ids_wm]), torch.as_tensor(logits)).numpy()
        np.testing.assert_allclose(wm, ref(np.asarray([ids_wm]), logits), rtol=0, atol=1e-5)
        ids_wm.append(int(np.argmax(wm)))
        ids_raw.append(int(np.argmax(logits)))
    det = port_wm.SynthIDTextWatermarkDetector(ours)
    jax_det = jax_wm.SynthIDTextWatermarkDetector(ref)
    for seq in (ids_wm, ids_raw):
        got, want = det(torch.as_tensor([seq])), jax_det(np.asarray([seq]))
        for key in ("mean_g_values", "z_score", "prediction"):
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-12)
    assert det(torch.as_tensor([ids_wm]))["z_score"][0] > 2.0
    assert (det(torch.as_tensor([ids_wm]))["mean_g_values"][0]
            > det(torch.as_tensor([ids_raw]))["mean_g_values"][0])


@pytest.mark.parametrize("current", [None, [], [3, 3, 7, 60], [5, 200, -1]],
                         ids=["no_state", "empty", "repeats", "out_of_vocab"])
def test_hamming_diversity_matches_jax(current):
    logits = np.random.default_rng(4).standard_normal((2, 64)).astype(np.float32)
    jax_proc = jax_lp.HammingDiversityLogitsProcessor(1.5, num_beams=4, num_beam_groups=2)
    port_proc = port_lp.HammingDiversityLogitsProcessor(1.5, num_beams=4, num_beam_groups=2)
    jax_state, port_state = {}, {}
    if current is not None:
        jax_state["current_tokens"] = jnp.asarray(current, jnp.int32)
        port_state["current_tokens"] = torch.as_tensor(current, dtype=torch.int64)
    ref = np.asarray(jax_proc(jnp.asarray(logits), jax_state))
    out = port_proc(torch.as_tensor(logits), port_state).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
