"""Beam search as one decode program: fixed buffers, a step on device tensors
only, captured once per signature as a CUDA graph on the card.

Port of ``transformers_tpu/generation/beam_search.py`` (``gather_cache``,
``build_beam_search_fn``; reference generation/utils.py:3197 ``_beam_search``,
the vectorized rewrite). Semantics as there:

- candidates are the top 2K of ``running_scores + logprobs`` over K*V;
- only EOS candidates ranked within the top K finalize a hypothesis, scored
  by ``/ gen_len ** length_penalty`` with ``gen_len = t + 1`` (the EOS
  included);
- the running beams are the top K candidates that are not EOS; the cache
  rows follow them (``StaticKVCache.reorder_``), and so do the token mask,
  from which the fused decode kernel derives each row's first live slot;
- done: every row has K finished hypotheses and, unless ``early_stopping``
  is True, the worst of them scores at least the best running beam
  normalized by ``max(t, 1)`` (``"never"`` behaves as False, as in JAX);
- at the end the running beams join the finished ones, normalized by
  ``max(t, 1)``, and the top ``num_return_sequences`` are returned.

The JAX loop is a ``lax.while_loop`` that tests ``t < max_new & ~all(done)``
before every step. Here the host replays steps in runs of
``EOS_CHECK_STEPS`` and reads ``alive`` back between runs, so a step may run
after the loop has ended: each step reads ``alive`` at its start and leaves
every buffer unchanged when it is false (its forward writes one cache slot
that nothing reads again).

``lax.top_k`` puts the lower index first among equal values; ``torch.topk``
promises no order among ties, and ties are common here (the -1e9 sentinel of
empty hypotheses, bf16 logits equal across the vocabulary). ``top_k`` below
ranks a unique int64 key per element, (score, -index), so the pick and its
order are JAX's.

As in the JAX package, no logits processor runs and ``do_sample`` is ignored
(there is no beam sampling), and the cache is the static one.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.cuda_build import CountedGraph, read_back

NEG = -1.0e9


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim of an f32 ``x``: the k largest values,
    descending, and their indices, the lower index first among equal values.
    Each element's key is its value's bits mapped to an order-preserving
    int32 in the high half of an int64 and ``2**31 - 1 - index`` in the low
    half: unique keys, so ``torch.topk`` has no ties to break."""
    bits = x.contiguous().view(torch.int32)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    idx = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    key = ordered * (1 << 32) + (0x7FFFFFFF - idx)
    top = torch.topk(key, k, dim=-1).values
    index = 0x7FFFFFFF - (top & 0xFFFFFFFF)
    return x.gather(-1, index), index


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(x, idx[..., None], axis=1)`` for x [B, N, T] and idx
    [B, M]: rows of x along dim 1."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


class BeamSearch:
    """The beam-search program of one signature: the static cache at B*K rows,
    the buffers, the step (``step``), captured on the card as a CUDA graph
    at its first use (``advance``), and the final pick (``finalize``).

    Buffers: ``ids`` / ``mask`` [B, K, T] of the running beams; ``running``
    [B, K] their scores; ``finished_seqs`` [B, K, T], ``finished_scores``
    and ``has_finished`` [B, K]; ``logprobs`` [B, K, V], pending (the last
    forward's, not yet ranked); ``t`` [1], tokens generated; ``alive`` [1],
    whether the JAX loop would run another step; ``rope_last`` [B]."""

    def __init__(self, model, signature: tuple, *, batch: int, num_beams: int, bucket: int,
                 total_len: int, max_new: int, eos_ids: tuple, pad_id: int,
                 length_penalty: float, early_stopping, num_return_sequences: int, cache_dtype):
        dev = model.device
        b, k = batch, num_beams
        self.signature = signature
        self.batch, self.num_beams, self.bucket = b, k, bucket
        self.total_len, self.max_new = total_len, max_new
        self.eos_ids, self.pad_id = eos_ids, pad_id
        self.length_penalty = float(length_penalty)
        self.early_stopping = early_stopping
        self.num_return_sequences = num_return_sequences
        self.cache = model.init_cache(b * k, total_len, dtype=cache_dtype)
        self.ids = torch.full((b, k, total_len), pad_id, dtype=torch.int64, device=dev)
        self.mask = torch.zeros((b, k, total_len), dtype=torch.int32, device=dev)
        self.running = torch.zeros((b, k), dtype=torch.float32, device=dev)
        self.finished_seqs = torch.full_like(self.ids, pad_id)
        self.finished_scores = torch.full((b, k), NEG, dtype=torch.float32, device=dev)
        self.has_finished = torch.zeros((b, k), dtype=torch.bool, device=dev)
        self.logprobs = torch.zeros((b, k, model.config.vocab_size), dtype=torch.float32,
                                    device=dev)
        self.t = torch.zeros(1, dtype=torch.int64, device=dev)
        self.alive = torch.ones(1, dtype=torch.bool, device=dev)
        self.rope_last = torch.zeros(b, dtype=torch.int64, device=dev)
        self.graph: Optional[CountedGraph] = None
        self.steps_run = 0  # steps of the last search, dead ones included

    def is_eos(self, tok: torch.Tensor) -> torch.Tensor:
        done = torch.zeros_like(tok, dtype=torch.bool)
        for e in self.eos_ids:
            done |= tok == e
        return done

    def norm(self, gen_len: torch.Tensor) -> torch.Tensor:
        return gen_len.to(torch.float32) ** self.length_penalty

    def done(self) -> torch.Tensor:
        """JAX ``done_fn`` over the buffers: [B] bool."""
        all_full = self.has_finished.all(dim=-1)
        if self.early_stopping is True or self.early_stopping == "always":
            return all_full
        best_running = self.running.max(dim=-1).values / self.norm(self.t.clamp_min(1))
        worst_finished = torch.where(self.has_finished, self.finished_scores,
                                     NEG).min(dim=-1).values
        return all_full & (worst_finished >= best_running)

    def set_alive(self) -> None:
        self.alive.copy_((self.t < self.max_new) & ~self.done().all())

    def _logprobs(self, logits: torch.Tensor) -> torch.Tensor:
        b, k = self.batch, self.num_beams
        return torch.log_softmax(logits[:, -1, :].float(), dim=-1).reshape(b, k, -1)

    def prefill(self, model, input_ids, attention_mask) -> None:
        """The prompt [B, bucket] at B*K rows through the model, and the
        buffers set as the JAX function sets them before its loop."""
        b, k, bucket = self.batch, self.num_beams, self.bucket
        self.ids.fill_(self.pad_id)
        self.ids[:, :, :bucket] = input_ids[:, None, :]
        self.mask.zero_()
        self.mask[:, :, :bucket] = attention_mask[:, None, :]
        prompt_pos = (attention_mask.cumsum(dim=-1) - 1).clamp_min(0)
        self.rope_last.copy_(prompt_pos[:, -1])
        out = model(input_ids=input_ids[:, None].expand(b, k, bucket).reshape(b * k, bucket),
                    attention_mask=self.mask.reshape(b * k, -1),
                    position_ids=prompt_pos[:, None].expand(b, k, bucket).reshape(b * k, bucket),
                    past_key_values=self.cache, cache_position=0, logits_to_keep=1)
        self.cache.device_slot(bucket)
        self.logprobs.copy_(self._logprobs(out.logits))
        self.running.fill_(NEG)
        self.running[:, 0] = 0.0
        self.finished_seqs.fill_(self.pad_id)
        self.finished_scores.fill_(NEG)
        self.has_finished.zero_()
        self.t.zero_()
        self.alive.fill_(self.max_new > 0)
        self.steps_run = 0

    def step(self, model) -> None:
        """One iteration of the JAX loop's body, on device tensors only, where
        ``alive`` holds; a no-op on the buffers where it does not."""
        b, k, total = self.batch, self.num_beams, self.total_len
        live = self.alive
        v = self.logprobs.shape[-1]
        cand = self.running[:, :, None] + self.logprobs
        top_scores, top_idx = top_k(cand.reshape(b, k * v), 2 * k)
        beam_src = top_idx // v
        token = top_idx % v
        # the slot of generated token t; a dead step past the last slot writes
        # (and its forward attends) at the last one, and keeps nothing
        slot = (self.t + self.bucket).clamp_max(total - 1)
        cand_ids = _take(self.ids, beam_src).index_copy_(2, slot, token[..., None])
        cand_mask = _take(self.mask, beam_src).index_fill_(2, slot, 1)

        cand_is_eos = self.is_eos(token)
        # only EOS candidates ranked within the top K finalize a hypothesis
        finalizes = cand_is_eos & (torch.arange(2 * k, device=token.device) < k)
        eos_scores = torch.where(finalizes, top_scores / self.norm(self.t + 1), NEG)
        f_scores, f_idx = top_k(torch.cat([self.finished_scores, eos_scores], dim=1), k)
        f_seqs = _take(torch.cat([self.finished_seqs, cand_ids], dim=1), f_idx)
        f_flag = torch.cat([self.has_finished, finalizes], dim=1).gather(1, f_idx)

        running, r_idx = top_k(torch.where(cand_is_eos, NEG, top_scores), k)
        new_src = beam_src.gather(1, r_idx)
        new_token = token.gather(1, r_idx)
        flat_idx = (torch.arange(b, device=token.device)[:, None] * k + new_src).reshape(-1)
        keep = torch.arange(b * k, device=token.device)

        for buf, new in ((self.finished_scores, f_scores), (self.finished_seqs, f_seqs),
                         (self.has_finished, f_flag), (self.running, running),
                         (self.ids, _take(cand_ids, r_idx)), (self.mask, _take(cand_mask, r_idx))):
            buf.copy_(torch.where(live, new, buf))
        self.cache.reorder_(torch.where(live, flat_idx, keep))

        # the chosen tokens' forward: the logits of token t + 1
        self.cache.slot.copy_(slot)
        position = (self.rope_last + self.t + 1)[:, None].expand(b, k).reshape(-1, 1)
        out = model(input_ids=new_token.reshape(b * k, 1),
                    attention_mask=self.mask.reshape(b * k, total), position_ids=position,
                    past_key_values=self.cache, cache_position=self.cache.slot, logits_to_keep=1)
        self.logprobs.copy_(torch.where(live, self._logprobs(out.logits), self.logprobs))
        self.t.add_(live.to(torch.int64))
        self.set_alive()

    def advance(self, model, n: int, graph: bool) -> None:
        """``n`` steps: with ``graph``, replays of the captured step (a first
        use runs one step for real and captures it); else the step function."""
        if n <= 0:
            return
        self.steps_run += n
        if not graph:
            for _ in range(n):
                self.step(model)
            return
        if self.graph is None:
            captured = CountedGraph()
            captured.capture_after_run(lambda: self.step(model))
            self.graph, n = captured, n - 1
        for _ in range(n):
            self.graph.replay()

    def finalize(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(sequences [B, R, T], scores [B, R]): the finished hypotheses and the
        running beams at their final length, best first."""
        b, k = self.batch, self.num_beams
        run_final = self.running / self.norm(self.t.clamp_min(1))
        all_scores = torch.cat([self.finished_scores, run_final], dim=1)
        valid = torch.cat([self.has_finished,
                           torch.ones((b, k), dtype=torch.bool, device=all_scores.device)], dim=1)
        top, idx = top_k(torch.where(valid, all_scores, 2 * NEG), self.num_return_sequences)
        return _take(torch.cat([self.finished_seqs, self.ids], dim=1), idx), top


def build_beam_search_fn(model, *, bucket: int, total_len: int, max_new: int, num_beams: int,
                         eos_ids: tuple, pad_id: int, length_penalty: float = 1.0,
                         early_stopping=False, cache_dtype=None, num_return_sequences: int = 1,
                         graph: Optional[bool] = None):
    """JAX ``build_beam_search_fn``: ``fn(prompt_ids [B, bucket], prompt_mask)``
    -> (sequences [B, R, total_len], scores [B, R]). Its ``BeamSearch``
    program takes the model's decode-program slot (the old program, and its
    cache, released first) and is kept there for the next call of the same
    signature. ``graph``: replay the captured step (the default on the card)
    or run the step function (the CPU, and the card's uncaptured reference).
    A failed capture raises and drops the program."""
    from .utils import EOS_CHECK_STEPS

    cache_dtype = cache_dtype or model.dtype
    if graph is None:
        graph = model.device.type == "cuda"

    @torch.inference_mode()
    def fn(prompt_ids, prompt_mask):
        b = prompt_ids.shape[0]
        signature = ("beam", b, num_beams, bucket, total_len, max_new, eos_ids, pad_id,
                     float(length_penalty), str(early_stopping), num_return_sequences,
                     str(cache_dtype))
        program = getattr(model, "_decode_program", None)
        if program is None or program.signature != signature:
            model._decode_program = None  # release the old cache, buffers and graph first
            program = model._decode_program = BeamSearch(
                model, signature, batch=b, num_beams=num_beams, bucket=bucket,
                total_len=total_len, max_new=max_new, eos_ids=eos_ids, pad_id=pad_id,
                length_penalty=length_penalty, early_stopping=early_stopping,
                num_return_sequences=num_return_sequences, cache_dtype=cache_dtype)
        try:
            program.prefill(model, prompt_ids, prompt_mask)
            done = 0
            while done < max_new:
                n = min(EOS_CHECK_STEPS, max_new - done)
                program.advance(model, n, graph)
                done += n
                if eos_ids and done < max_new and not bool(read_back(program.alive)):
                    break
            return program.finalize()
        except BaseException:
            model._decode_program = None  # a failed capture leaves no half-built program
            raise

    return fn
