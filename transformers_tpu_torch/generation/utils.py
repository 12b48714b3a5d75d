"""Generation: a prefill, then a decode loop whose step is one captured device
program on the card.

Port of ``transformers_tpu/generation/utils.py`` (``GenerationMixin.generate``,
``_generate_streaming``, ``_build_generate_fn``; reference
generation/utils.py:2250 ``generate``, :2772 ``_sample``). The JAX package
compiles the prefill and a ``lax.while_loop`` decode into one XLA program per
signature. Its counterpart here is ``StaticDecode``: the static cache, fixed
buffers and the decode step of one signature (batch, bucket, total length,
``do_sample``, EOS and pad ids, processors, cache dtype, and
``cache_implementation``: "quantized" builds the int8 cache, any other value
the static one, as the JAX package does). On the card the
step is captured once as a CUDA graph, after one step run for real, and
replayed per token; on the CPU the same step function runs in a Python loop.
The model keeps only the newest signature's program, which holds a whole KV
cache, and releases the old one before it builds a new one.

Prompts are left-padded to a multiple of ``prompt_pad_multiple``; the cache
holds ``bucket + max_new_tokens`` slots, or ``max_new_tokens`` padded to
``decode_pad_multiple`` when that is set (the actual ``max_new_tokens`` is
then only the loop's bound). The host reads ``finished`` back every
``EOS_CHECK_STEPS`` steps, and only when there are EOS ids: a finished row
writes pad, so the ids equal those of a loop that stops at once.

A streamer, ``stopping_criteria`` or ``stop_strings`` take the streaming
route (``_generate_streaming``), which runs the same step and reads every
step back, since a streamer or a host criterion sees each token.

``generate_batch`` and ``init_continuous_batching`` serve requests through
the continuous-batching engine over paged KV (``continuous_batching/``).

Not ported yet: beam search, assisted decoding, watermarking and seq2seq.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..ops.cuda_build import CountedGraph, read_back
from .configuration_utils import GenerationConfig
from .logits_process import (LogitsProcessorList, MinNewTokensLengthLogitsProcessor,
                             MinPLogitsWarper, NoRepeatNGramLogitsProcessor,
                             RepetitionPenaltyLogitsProcessor,
                             SuppressTokensAtBeginLogitsProcessor, SuppressTokensLogitsProcessor,
                             TemperatureLogitsWarper, TopKLogitsWarper, TopPLogitsWarper,
                             as_ids, processor_signature)
from .stopping_criteria import StoppingCriteriaList, StopStringCriteria

logger = logging.getLogger(__name__)

# decode steps between two host reads of ``finished``
EOS_CHECK_STEPS = 16


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


class StaticDecode:
    """The decode program of one signature: the static cache, fixed buffers,
    and the decode step over them (``step``), captured on the card as a CUDA
    graph at its first use (``advance``; ``graph.capture_ms`` is its host time).

    Buffers: ``ids`` [B, T] and ``mask`` [B, T]; the pending token
    ``next_tok`` [B] (sampled, not yet written or run); ``live`` [B], set
    where the pending token came from a row that had not finished (its mask
    bit); ``finished`` [B]; ``rope_last`` [B], each row's last prompt
    position. The cache's one-element slot tensor is the step's clock: the
    pending token's slot, set once after the prefill and advanced by each
    step on the device."""

    def __init__(self, model, signature: tuple, *, batch: int, bucket: int, total_len: int,
                 do_sample: bool, eos_ids: tuple, pad_id: int,
                 processors: LogitsProcessorList, cache_dtype, cache_implementation: str):
        dev = model.device
        self.signature = signature
        self.bucket = bucket
        self.do_sample = do_sample
        self.eos_ids = eos_ids
        self.pad_id = pad_id
        self.processors = processors
        self.cache = model.init_cache(batch, total_len, dtype=cache_dtype,
                                      implementation=cache_implementation)
        self.ids = torch.full((batch, total_len), pad_id, dtype=torch.int64, device=dev)
        self.mask = torch.zeros((batch, total_len), dtype=torch.int32, device=dev)
        self.rope_last = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.next_tok = torch.zeros(batch, dtype=torch.int64, device=dev)
        self.live = torch.ones(batch, dtype=torch.bool, device=dev)
        self.finished = torch.zeros(batch, dtype=torch.bool, device=dev)
        self.graph: Optional[CountedGraph] = None
        # the captured draws' own generator: set from the caller's before the
        # replays and copied back after them
        self.generator: Optional[torch.Generator] = None

    def draw(self, logits: torch.Tensor, state: dict, generator) -> torch.Tensor:
        """The processors, then argmax, or a draw from the softmax: argmax(p /
        q) with q ~ Exp(1) from ``generator``, which is how ``multinomial``
        draws one sample, without its host-side checks."""
        logits = self.processors(logits.float(), state)
        if not self.do_sample:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits, dim=-1)
        return probs.div(torch.empty_like(probs).exponential_(1.0, generator=generator)).argmax(-1)

    def is_eos(self, tok: torch.Tensor) -> torch.Tensor:
        done = torch.zeros_like(tok, dtype=torch.bool)
        for e in self.eos_ids:
            done |= tok == e
        return done

    def prefill(self, model, input_ids, attention_mask, generator) -> None:
        """The prompt [B, bucket] through the model (reference _prefill,
        generation/utils.py:3893) and the first token drawn, pending at slot
        ``bucket``."""
        bucket = self.bucket
        dev = self.ids.device
        self.ids.fill_(self.pad_id)
        self.ids[:, :bucket] = input_ids
        self.mask.zero_()
        self.mask[:, :bucket] = attention_mask
        prompt_pos = (attention_mask.cumsum(dim=-1) - 1).clamp_min(0)  # rope positions
        self.rope_last.copy_(prompt_pos[:, -1])
        out = model(input_ids=input_ids, attention_mask=self.mask, position_ids=prompt_pos,
                    past_key_values=self.cache, cache_position=0, logits_to_keep=1)
        state = {"ids": self.ids, "mask": self.mask,
                 "pos": torch.full((), bucket, dtype=torch.int64, device=dev),
                 "gen_count": torch.zeros((), dtype=torch.int64, device=dev)}
        tok = self.draw(out.logits[:, -1, :], state, generator)
        self.next_tok.copy_(tok)
        self.finished.copy_(self.is_eos(tok))
        self.live.fill_(True)
        self.cache.device_slot(bucket)

    def step(self, model, generator) -> None:
        """One decode step over the fixed buffers, on device tensors only: the
        pending token into ``ids`` and ``mask`` at the slot tensor, the
        forward at rope position ``rope_last + g`` (g tokens generated, the
        pending one included), the processors and the draw, the new pending
        token (pad on finished rows) and ``finished``, then ``slot += 1``."""
        slot = self.cache.slot
        idx = slot.long()
        self.ids.index_copy_(1, idx, self.next_tok[:, None])
        self.mask.index_copy_(1, idx, self.live[:, None].to(torch.int32))
        pos = idx[0] + 1  # the slot the drawn token goes to
        gen_count = pos - self.bucket
        out = model(input_ids=self.next_tok[:, None], attention_mask=self.mask,
                    position_ids=(self.rope_last + gen_count)[:, None],
                    past_key_values=self.cache, cache_position=slot, logits_to_keep=1)
        state = {"ids": self.ids, "mask": self.mask, "pos": pos, "gen_count": gen_count}
        sampled = self.draw(out.logits[:, -1, :], state, generator)
        self.live.copy_(~self.finished)
        self.next_tok.copy_(torch.where(self.finished, self.pad_id, sampled))
        self.finished |= self.is_eos(sampled)
        self.cache.advance_slot()

    def advance(self, model, n: int, generator, graph: bool) -> None:
        """``n`` decode steps: with ``graph``, replays of the captured step (a
        first use runs one step for real and captures it); else the step
        function."""
        if n <= 0:
            return
        if not graph:
            for _ in range(n):
                self.step(model, generator)
            return
        if self.graph is None:
            # one step for real, then the capture; a failed capture raises
            if self.do_sample:
                self.generator = torch.Generator(device=self.ids.device)
            captured = CountedGraph(generator=self.generator)
            captured.capture_after_run(lambda: self.step(model, generator),
                                       lambda: self.step(model, self.generator))
            self.graph, n = captured, n - 1
        if self.generator is not None:
            self.generator.set_state(generator.get_state())
        for _ in range(n):
            self.graph.replay()
        if self.generator is not None:
            generator.set_state(self.generator.get_state())

    def write_pending(self) -> None:
        """The pending token into ``ids`` at the slot tensor."""
        self.ids.index_copy_(1, self.cache.slot.long(), self.next_tok[:, None])


class GenerationMixin:
    """Mixin for causal decoders. The host class provides ``forward(input_ids,
    attention_mask, position_ids, past_key_values, cache_position,
    logits_to_keep=...)``, ``init_cache``, ``config`` and ``device``."""

    def generate_batch(self, inputs, **kwargs):
        """Continuous-batching batch generation over paged KV (reference
        continuous_api.py:1202 ContinuousMixin.generate_batch)."""
        from .continuous_batching import ContinuousMixin

        return ContinuousMixin.generate_batch(self, inputs, **kwargs)

    def init_continuous_batching(self, **kwargs):
        """A ``ContinuousBatchingManager`` (background engine thread) over this
        model."""
        from .continuous_batching import ContinuousMixin

        return ContinuousMixin.init_continuous_batching(self, **kwargs)

    def _get_logits_processors(self, gen: GenerationConfig, eos_ids: tuple,
                               max_new_tokens: int) -> LogitsProcessorList:
        """reference generation/utils.py:2641 ``_get_logits_processor``"""
        procs = LogitsProcessorList()
        if gen.repetition_penalty is not None and gen.repetition_penalty != 1.0:
            procs.append(RepetitionPenaltyLogitsProcessor(gen.repetition_penalty))
        if gen.no_repeat_ngram_size and gen.no_repeat_ngram_size > 0:
            procs.append(NoRepeatNGramLogitsProcessor(gen.no_repeat_ngram_size))
        if gen.min_new_tokens and eos_ids:
            procs.append(MinNewTokensLengthLogitsProcessor(gen.min_new_tokens, eos_ids))
        if gen.suppress_tokens:
            procs.append(SuppressTokensLogitsProcessor(gen.suppress_tokens))
        if gen.begin_suppress_tokens:
            procs.append(SuppressTokensAtBeginLogitsProcessor(gen.begin_suppress_tokens))
        if gen.do_sample:
            if gen.temperature is not None and gen.temperature != 1.0:
                procs.append(TemperatureLogitsWarper(gen.temperature))
            if gen.top_k is not None and gen.top_k > 0:
                procs.append(TopKLogitsWarper(gen.top_k))
            if gen.top_p is not None and gen.top_p < 1.0:
                procs.append(TopPLogitsWarper(gen.top_p))
            if gen.min_p is not None:
                procs.append(MinPLogitsWarper(gen.min_p))
        return procs

    def generate(self, input_ids, attention_mask=None,
                 generation_config: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None, cache_dtype=None, streamer=None,
                 stopping_criteria=None, stop_strings=None, tokenizer=None,
                 **kwargs) -> torch.Tensor:
        """Reference generation/utils.py:2250. Returns [B, bucket + max_new]
        token ids: the left-padded prompt, the generated tokens, and pad after
        EOS; on the streaming route (a ``streamer``, ``stopping_criteria`` or
        ``stop_strings`` with a ``tokenizer``), cut after the last step run.
        ``generator`` drives sampling (``do_sample=True``); unseeded when not
        given. On the card the decode step runs as replays of a captured CUDA
        graph; a failed capture raises. The model's decode program (cache,
        buffers, graph) serves one call at a time."""
        return self._generate(input_ids, graph=self.device.type == "cuda",
                              attention_mask=attention_mask, generation_config=generation_config,
                              generator=generator, cache_dtype=cache_dtype, streamer=streamer,
                              stopping_criteria=stopping_criteria, stop_strings=stop_strings,
                              tokenizer=tokenizer, **kwargs)

    @torch.inference_mode()
    def _generate(self, input_ids, *, graph: bool, attention_mask=None, generation_config=None,
                  generator=None, cache_dtype=None, streamer=None, stopping_criteria=None,
                  stop_strings=None, tokenizer=None, **kwargs) -> torch.Tensor:
        """``generate`` with the decode step replayed from a CUDA graph
        (``graph``) or run as a function (the CPU, and the card's uncaptured
        reference)."""
        gen = (generation_config or getattr(self, "generation_config", None)
               or GenerationConfig()).copy()
        unused = gen.update(**kwargs)
        if unused:
            logger.warning(f"generate() ignoring unknown kwargs: {sorted(unused)}")
        gen.validate()
        if gen.num_beams and gen.num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")

        dev = self.device
        input_ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
        if input_ids.ndim == 1:
            input_ids = input_ids[None, :]
        b, s_in = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s_in), dtype=torch.int32, device=dev)
        else:
            attention_mask = torch.as_tensor(attention_mask, device=dev).to(torch.int32)

        eos_ids = as_ids(gen.eos_token_id if gen.eos_token_id is not None
                         else getattr(self.config, "eos_token_id", None))
        pad_id = gen.pad_token_id
        if pad_id is None:
            pad_id = getattr(self.config, "pad_token_id", None)
        if pad_id is None:
            pad_id = eos_ids[0] if eos_ids else 0
        pad_id = int(pad_id)
        max_new = (int(gen.max_new_tokens) if gen.max_new_tokens is not None
                   else max(int(gen.max_length) - s_in, 1))

        # left-pad the prompts to the bucket length
        bucket = pad_to_multiple(max(s_in, 1), gen.prompt_pad_multiple)
        pad_amt = bucket - s_in
        if pad_amt:
            input_ids = torch.nn.functional.pad(input_ids, (pad_amt, 0), value=pad_id)
            attention_mask = torch.nn.functional.pad(attention_mask, (pad_amt, 0), value=0)
        # the cache and the captured step are sized for the padded cap; the
        # actual max_new only bounds the loop
        max_new_cap = (pad_to_multiple(max_new, gen.decode_pad_multiple)
                       if gen.decode_pad_multiple else max_new)
        total_len = bucket + max_new_cap

        do_sample = bool(gen.do_sample)
        if do_sample and generator is None:
            generator = torch.Generator(device=dev)
            generator.seed()
        processors = self._get_logits_processors(gen, eos_ids, max_new)
        cache_dtype = cache_dtype or self.dtype
        # "quantized" builds the int8 cache, any other accepted value the static one
        cache_impl = gen.cache_implementation or "static"
        signature = (b, bucket, total_len, do_sample, eos_ids, pad_id,
                     processor_signature(processors), str(cache_dtype), cache_impl)
        if getattr(self, "_decode_program", None) is None \
                or self._decode_program.signature != signature:
            self._decode_program = None  # release the old cache, buffers and graph first
            self._decode_program = StaticDecode(
                self, signature, batch=b, bucket=bucket, total_len=total_len,
                do_sample=do_sample, eos_ids=eos_ids, pad_id=pad_id, processors=processors,
                cache_dtype=cache_dtype, cache_implementation=cache_impl)
        program = self._decode_program
        try:
            program.prefill(self, input_ids, attention_mask, generator)
            if streamer is not None or stopping_criteria is not None \
                    or stop_strings is not None:
                return self._generate_streaming(
                    program, input_ids, max_new=max_new, generator=generator, graph=graph,
                    streamer=streamer, stopping_criteria=stopping_criteria,
                    stop_strings=stop_strings, tokenizer=tokenizer)
            steps, done = max_new - 1, 0
            while done < steps:
                n = min(EOS_CHECK_STEPS, steps - done)
                program.advance(self, n, generator, graph)
                done += n
                if eos_ids and done < steps and bool(read_back(program.finished.all())):
                    break
        except BaseException:
            self._decode_program = None  # a failed capture leaves no half-built program
            raise
        program.write_pending()
        return program.ids[:, :bucket + max_new].clone()

    def _generate_streaming(self, program: StaticDecode, input_ids, *, max_new, generator,
                            graph, streamer, stopping_criteria, stop_strings, tokenizer):
        """The decode loop with a host read of every step (the reference's
        per-token loop, generation/utils.py:2864): the streamer gets the
        prompt, then each token; the criteria see the ids so far, and a row
        they stop writes pad (mask 0) from then on. The step is the same as
        ``generate``'s, replayed from its graph on the card."""
        criteria = StoppingCriteriaList(stopping_criteria or [])
        if stop_strings is not None:
            if tokenizer is None:
                raise ValueError("stop_strings requires `tokenizer=` (reference parity)")
            criteria.append(StopStringCriteria(tokenizer, stop_strings))
        b, bucket = input_ids.shape
        prompt = input_ids.cpu().numpy()
        ids = np.concatenate([prompt, np.full((b, max_new), program.pad_id, np.int64)], axis=1)
        if streamer is not None:
            streamer.put(prompt.copy())
        finished = np.zeros((b,), bool)
        for g in range(1, max_new + 1):
            slot = bucket + g - 1
            ids[:, slot] = read_back(program.next_tok).numpy()
            if streamer is not None:
                streamer.put(ids[:, slot:slot + 1].copy())
            finished |= np.isin(ids[:, slot], program.eos_ids)
            if criteria:
                finished |= criteria(ids[:, :slot + 1])
            if finished.all() or g == max_new:
                break
            program.finished.copy_(torch.from_numpy(finished))
            program.advance(self, 1, generator, graph)
        if streamer is not None:
            streamer.end()
        return torch.from_numpy(ids[:, :slot + 1]).to(input_ids.device)
