"""Assisted (speculative) decoding.

Port of ``transformers_tpu/generation/candidate_generator.py`` (reference
generation/candidate_generator.py: :39 base, :80 AssistedCandidateGenerator,
:1013 PromptLookupCandidateGenerator; generation/utils.py:3551
``_assisted_decoding`` and :3981 ``_speculative_sampling``).

A draft (a smaller model sharing the target's tokenizer, or an n-gram lookup
in the context) proposes up to ``gamma`` tokens; the target verifies them in
one forward of the window, and the acceptance bookkeeping runs on the host
(its lengths depend on the data), with both verification modes:

- greedy: the longest prefix of proposals equal to the target's argmax, so
  the output is the target's greedy output token for token;
- sampling: the speculative-sampling rule (Leviathan et al.): accept draft
  x_i with probability min(1, p_i(x_i) / q_i(x_i)); on a rejection, draw from
  norm(max(0, p_i - q_i)). The draws come from numpy ``default_rng`` streams,
  ``seed`` for the verifier and ``seed + 1`` for the draft, as in the JAX
  package, so the same logits give the same tokens.

Each model keeps its own static cache; a rejection moves only the
``committed`` pointer back, and the mask hides the stale slots past it.
Routes through the decoder: a width-1 step (a draft step, a width-1 verify)
takes the fused decode kernel, the first verify over the prompt at slot 0
the static prefill (the flash kernel), and a wider window at a later slot
the unfused cached attention, as in the JAX package. The forwards run
uncaptured, each with a host read of its logits.

Reached through ``generate(assistant_model=...)`` and
``generate(prompt_lookup_num_tokens=...)`` (generation/utils.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _softmax(x):
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


def _forward(model, cache, tokens, start: int, max_len: int) -> np.ndarray:
    """``tokens`` (one row) through ``model`` at cache slots ``start ..``, with
    every slot before the last of them valid: the logits of each position
    [width, V], as float32 on the host."""
    dev = model.device
    width = len(tokens)
    mask = torch.zeros((1, max_len), dtype=torch.int32, device=dev)
    mask[0, :start + width] = 1
    out = model(input_ids=torch.tensor([tokens], dtype=torch.int64, device=dev),
                attention_mask=mask,
                position_ids=torch.arange(start, start + width, device=dev)[None],
                past_key_values=cache, cache_position=start)
    return out.logits[0].float().cpu().numpy()


class _CandidateGenerator:
    """Base contract (reference candidate_generator.py:39): propose up to
    ``gamma`` continuation tokens given the committed context."""

    def get_candidates(self, ctx_ids: list) -> tuple:
        """Returns (candidate tokens, per-candidate draft probs [n, V] or None
        when the proposal is deterministic given the context)."""
        raise NotImplementedError

    def observe(self, n_accepted: int, n_proposed: int):
        """Feedback hook (reference dynamic num_assistant_tokens schedule)."""


class PromptLookupCandidateGenerator(_CandidateGenerator):
    """N-gram prompt lookup (reference candidate_generator.py:1013): find the
    latest earlier occurrence of the current tail n-gram and propose its
    continuation. Deterministic: a draft distribution concentrated on the
    proposed token."""

    def __init__(self, num_output_tokens: int = 10, max_matching_ngram_size: int = 2):
        self.num_output_tokens = num_output_tokens
        self.max_ngram = max_matching_ngram_size

    def get_candidates(self, ctx_ids):
        ids = np.asarray(ctx_ids)
        n = len(ids)
        for ngram in range(min(self.max_ngram, n - 1), 0, -1):
            tail = ids[n - ngram:]
            # windows over the context, the tail itself excluded
            for start in range(n - ngram - 1, -1, -1):
                if np.array_equal(ids[start:start + ngram], tail):
                    cont = ids[start + ngram: start + ngram + self.num_output_tokens]
                    if len(cont):
                        return [int(t) for t in cont], None
        return [], None


class AssistedCandidateGenerator(_CandidateGenerator):
    """Draft-model proposals (reference candidate_generator.py:80). The draft
    shares the target's tokenizer; it runs its own static cache, kept in step
    with the committed context."""

    def __init__(self, draft_model, *, num_assistant_tokens: int = 5, max_len: int = 512,
                 do_sample: bool = False, temperature: float = 1.0,
                 rng: Optional[np.random.Generator] = None):
        self.model = draft_model
        self.gamma = int(num_assistant_tokens)
        self.max_len = max_len
        self.do_sample = do_sample
        self.temperature = temperature
        self.rng = rng or np.random.default_rng(0)
        self._cache = None
        self._committed = 0  # tokens already in the draft cache

    def _catch_up(self, ctx_ids):
        """Feed the committed tokens the draft has not seen through it in one
        forward (the prompt's is its prefill); the last token is left for the
        proposal loop."""
        if self._cache is None:
            self._cache = self.model.init_cache(1, self.max_len, dtype=self.model.dtype)
        n = len(ctx_ids)
        if self._committed < n - 1:
            _forward(self.model, self._cache, [int(t) for t in ctx_ids[self._committed:n - 1]],
                     self._committed, self.max_len)
            self._committed = n - 1

    def get_candidates(self, ctx_ids):
        if len(ctx_ids) + self.gamma + 1 >= self.max_len:
            return [], None
        self._catch_up(ctx_ids)
        proposals, probs = [], []
        tok = int(ctx_ids[-1])
        pos = len(ctx_ids) - 1
        for _ in range(self.gamma):
            lg = _forward(self.model, self._cache, [tok], pos, self.max_len)[-1]
            if self.do_sample:
                q = _softmax(lg / max(self.temperature, 1e-6))
                tok = int(self.rng.choice(len(q), p=q))
            else:
                q = np.zeros_like(lg)
                q[int(np.argmax(lg))] = 1.0
                tok = int(np.argmax(lg))
            proposals.append(tok)
            probs.append(q)
            pos += 1
        # the proposals' cache slots are provisional: _catch_up writes the
        # committed tokens over them
        return proposals, np.stack(probs) if probs else None


class SpeculativeDecoder:
    """The draft / verify loop with greedy or speculative-sampling verification
    (reference _assisted_decoding utils.py:3551, _speculative_sampling :3981)."""

    def __init__(self, model, candidate_generator, *, max_len: int = 512,
                 do_sample: bool = False, temperature: float = 1.0, seed: int = 0):
        self.model = model
        self.cand = candidate_generator
        self.max_len = max_len
        self.do_sample = do_sample
        self.temperature = temperature
        self.rng = np.random.default_rng(seed)

    @torch.inference_mode()
    def generate(self, input_ids=None, max_new_tokens: int = 32, eos_token_id=None) -> np.ndarray:
        """[1, S + n] int64 ids on the host: the prompt, then at most
        ``max_new_tokens`` tokens, ending at the first EOS."""
        ids = torch.as_tensor(input_ids).cpu().numpy()
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[0] != 1:
            raise ValueError("assisted decoding supports batch size 1 (reference parity)")
        eos = (eos_token_id if eos_token_id is not None
               else getattr(self.model.config, "eos_token_id", None))
        eos_ids = set(eos if isinstance(eos, (list, tuple)) else ([eos] if eos is not None else []))
        eos_ids.discard(None)

        prompt = [int(t) for t in ids[0]]
        tokens = list(prompt)  # committed tokens: the prompt and those accepted
        cache = self.model.init_cache(1, self.max_len, dtype=self.model.dtype)
        committed = 0  # slots of the target's cache that hold committed tokens

        def verify(window_tokens):
            nonlocal committed
            logits = _forward(self.model, cache, window_tokens, committed, self.max_len)
            committed += len(window_tokens)
            return logits

        next_logits = verify(tokens)[-1]
        n_gen = 0
        while n_gen < max_new_tokens:
            first = self._pick(next_logits)
            tokens.append(first)
            n_gen += 1
            if first in eos_ids or n_gen >= max_new_tokens or committed + 2 >= self.max_len:
                break

            proposals, draft_probs = self.cand.get_candidates(tokens)
            room = self.max_len - committed - 2
            limit = max(0, min(len(proposals), room, max_new_tokens - n_gen))
            proposals = list(proposals[:limit])
            if draft_probs is not None:
                draft_probs = draft_probs[:limit]

            window = [first] + proposals
            logits = verify(window)  # logits[i]: the distribution after window[:i + 1]

            n_accept = 0
            replacement = None
            for i, prop in enumerate(proposals):
                if self.do_sample:
                    p = _softmax(logits[i] / max(self.temperature, 1e-6))
                    q = draft_probs[i] if draft_probs is not None else None
                    if q is None:
                        # deterministic draft: the rule with q a delta
                        if self.rng.random() < p[prop]:
                            n_accept += 1
                            continue
                        resid = p.copy()
                        resid[prop] = 0.0
                    else:
                        if self.rng.random() < min(1.0, p[prop] / max(q[prop], 1e-20)):
                            n_accept += 1
                            continue
                        resid = np.maximum(p - q, 0.0)
                    s = resid.sum()
                    resid = resid / s if s > 0 else p
                    replacement = int(self.rng.choice(len(resid), p=resid))
                    break
                if prop == int(np.argmax(logits[i])):
                    n_accept += 1
                    continue
                replacement = int(np.argmax(logits[i]))
                break

            tokens.extend(proposals[:n_accept])
            n_gen += n_accept
            self.cand.observe(n_accept, len(proposals))
            # only [first] and the accepted proposals stay committed
            committed = committed - len(window) + 1 + n_accept

            if any(t in eos_ids for t in proposals[:n_accept]) or n_gen >= max_new_tokens:
                break
            if replacement is not None:
                tokens.append(replacement)
                n_gen += 1
                if (replacement in eos_ids or n_gen >= max_new_tokens
                        or committed + 2 >= self.max_len):
                    break
                next_logits = verify([replacement])[-1]
            else:
                # every proposal accepted: the window's last position is the
                # next round's first distribution, its KV already committed
                next_logits = logits[len(window) - 1]

        seq = prompt + tokens[len(prompt):][:max_new_tokens]
        return np.asarray([seq], np.int64)

    def _pick(self, logits):
        if self.do_sample:
            p = _softmax(logits / max(self.temperature, 1e-6))
            return int(self.rng.choice(len(p), p=p))
        return int(np.argmax(logits))


def assisted_generate(model, assistant_model=None, input_ids=None, *, max_new_tokens: int = 32,
                      num_assistant_tokens: int = 5, eos_token_id=None, max_len: int = 512,
                      do_sample: bool = False, temperature: float = 1.0, seed: int = 0,
                      prompt_lookup_num_tokens: Optional[int] = None) -> np.ndarray:
    """Functional entry (reference ``generate(assistant_model=...)`` route): the
    draft is ``assistant_model``, or the prompt lookup when
    ``prompt_lookup_num_tokens`` is set."""
    if prompt_lookup_num_tokens is not None:
        cand = PromptLookupCandidateGenerator(num_output_tokens=prompt_lookup_num_tokens)
    else:
        cand = AssistedCandidateGenerator(
            assistant_model, num_assistant_tokens=num_assistant_tokens, max_len=max_len,
            do_sample=do_sample, temperature=temperature, rng=np.random.default_rng(seed + 1))
    dec = SpeculativeDecoder(model, cand, max_len=max_len, do_sample=do_sample,
                             temperature=temperature, seed=seed)
    return dec.generate(input_ids=input_ids, max_new_tokens=max_new_tokens,
                        eos_token_id=eos_token_id)


class AssistedDecoder:
    """The older entry (JAX ``AssistedDecoder``): ``generate`` over
    ``assisted_generate``."""

    def __init__(self, model, assistant_model, *, num_assistant_tokens: int = 5,
                 max_len: int = 512):
        self.model = model
        self.draft = assistant_model
        self.gamma = num_assistant_tokens
        self.max_len = max_len

    def generate(self, input_ids=None, max_new_tokens: int = 32, eos_token_id=None):
        return assisted_generate(self.model, self.draft, input_ids,
                                 max_new_tokens=max_new_tokens, num_assistant_tokens=self.gamma,
                                 eos_token_id=eos_token_id, max_len=self.max_len)
