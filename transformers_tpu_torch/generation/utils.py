"""Generation: a prefill and then a token-by-token decode loop over a static cache.

Port of ``transformers_tpu/generation/utils.py`` (``GenerationMixin.generate``
and ``_build_generate_fn``; reference generation/utils.py:2250 ``generate``,
:2772 ``_sample``). Prompts are left-padded to a multiple of
``prompt_pad_multiple``; the cache holds ``bucket + max_new_tokens`` slots.
The JAX ``lax.while_loop`` is a Python loop here; argmax and sampling run on
the device, and the loop reads ``finished`` back from it only when there are
EOS ids to stop on.

``generate_batch`` and ``init_continuous_batching`` serve requests through
the continuous-batching engine over paged KV (``continuous_batching/``).

Not ported yet: streamers, stopping criteria and stop strings, beam search,
assisted decoding, and the logits processors other than temperature, top-k
and top-p (asking for one raises).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from .configuration_utils import GenerationConfig
from .logits_process import (LogitsProcessorList, TemperatureLogitsWarper, TopKLogitsWarper,
                             TopPLogitsWarper)

logger = logging.getLogger(__name__)


def _as_tuple(x) -> tuple:
    if x is None:
        return ()
    if isinstance(x, (list, tuple)):
        return tuple(int(v) for v in x)
    return (int(x),)


def pad_to_multiple(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple


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

    @staticmethod
    def _get_logits_processors(gen: GenerationConfig) -> LogitsProcessorList:
        """reference generation/utils.py:2641 ``_get_logits_processor``"""
        unported = {
            "repetition_penalty": gen.repetition_penalty not in (None, 1.0),
            "no_repeat_ngram_size": bool(gen.no_repeat_ngram_size),
            "min_new_tokens": bool(gen.min_new_tokens),
            "suppress_tokens": bool(gen.suppress_tokens),
            "begin_suppress_tokens": bool(gen.begin_suppress_tokens),
            "min_p": gen.do_sample and gen.min_p is not None,
        }
        asked = [k for k, v in unported.items() if v]
        if asked:
            raise NotImplementedError(f"logits processors not ported yet: {asked}")
        procs = LogitsProcessorList()
        if gen.do_sample:
            if gen.temperature is not None and gen.temperature != 1.0:
                procs.append(TemperatureLogitsWarper(gen.temperature))
            if gen.top_k is not None and gen.top_k > 0:
                procs.append(TopKLogitsWarper(gen.top_k))
            if gen.top_p is not None and gen.top_p < 1.0:
                procs.append(TopPLogitsWarper(gen.top_p))
        return procs

    @torch.inference_mode()
    def generate(self, input_ids, attention_mask=None,
                 generation_config: Optional[GenerationConfig] = None,
                 generator: Optional[torch.Generator] = None, cache_dtype=None,
                 **kwargs) -> torch.Tensor:
        """Reference generation/utils.py:2250. Returns [B, bucket + max_new]
        token ids: the left-padded prompt, the generated tokens, and pad after
        EOS. ``generator`` drives sampling (``do_sample=True``); unseeded when
        not given."""
        gen = (generation_config or getattr(self, "generation_config", None)
               or GenerationConfig()).copy()
        unused = gen.update(**kwargs)
        if unused:
            logger.warning(f"generate() ignoring unknown kwargs: {sorted(unused)}")
        gen.validate()
        if gen.num_beams and gen.num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")
        processors = self._get_logits_processors(gen)

        dev = self.device
        input_ids = torch.as_tensor(input_ids, device=dev).to(torch.int64)
        if input_ids.ndim == 1:
            input_ids = input_ids[None, :]
        b, s_in = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s_in), dtype=torch.int32, device=dev)
        else:
            attention_mask = torch.as_tensor(attention_mask, device=dev).to(torch.int32)

        eos_ids = _as_tuple(gen.eos_token_id if gen.eos_token_id is not None
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
        total_len = bucket + max_new

        do_sample = bool(gen.do_sample)
        if do_sample and generator is None:
            generator = torch.Generator(device=dev)
            generator.seed()
        eos = torch.tensor(eos_ids, dtype=torch.int64, device=dev)

        def sample_next(logits, state):  # logits [B, V]
            logits = processors(logits.float(), state)
            if do_sample:
                probs = torch.softmax(logits, dim=-1)
                return torch.multinomial(probs, 1, generator=generator)[:, 0]
            return logits.argmax(dim=-1)

        cache = self.init_cache(b, total_len, dtype=cache_dtype)
        ids = torch.full((b, total_len), pad_id, dtype=torch.int64, device=dev)
        ids[:, :bucket] = input_ids
        mask = torch.zeros((b, total_len), dtype=torch.int32, device=dev)
        mask[:, :bucket] = attention_mask
        prompt_pos = (attention_mask.cumsum(dim=-1) - 1).clamp_min(0)  # rope positions
        rope_last = prompt_pos[:, -1]  # position of each row's last prompt token

        # prefill (reference _prefill, generation/utils.py:3893)
        out = self(input_ids=input_ids, attention_mask=mask, position_ids=prompt_pos,
                   past_key_values=cache, cache_position=0, logits_to_keep=1)
        state = {"ids": ids, "mask": mask, "pos": bucket, "gen_count": 0}
        next_tok = sample_next(out.logits[:, -1, :], state)
        finished = torch.isin(next_tok, eos)

        # decode loop: the pending token goes into slot bucket + g - 1
        g = 1
        while g < max_new and not (eos_ids and bool(finished.all())):
            slot = bucket + g - 1
            ids[:, slot] = next_tok
            mask[:, slot] = 1
            out = self(input_ids=next_tok[:, None], attention_mask=mask,
                       position_ids=(rope_last + g)[:, None], past_key_values=cache,
                       cache_position=slot, logits_to_keep=1)
            state = {"ids": ids, "mask": mask, "pos": slot + 1, "gen_count": g}
            sampled = sample_next(out.logits[:, -1, :], state)
            next_tok = torch.where(finished, pad_id, sampled)
            finished = finished | torch.isin(sampled, eos)
            g += 1
        ids[:, bucket + g - 1] = next_tok
        return ids
