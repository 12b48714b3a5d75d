"""Logits processors: functions of ``(logits, state)`` that a captured decode
step can hold.

Port of ``transformers_tpu/generation/logits_process.py`` (reference
src/transformers/generation/logits_process.py): every decoder-only processor
of the JAX file. ``state`` carries the decode buffers as device tensors:

    state = {
        "ids": [B, T] token buffer (left-padded prompt, then generated),
        "mask": [B, T] validity,
        "pos": 0-d tensor, the slot the next token goes to,
        "gen_count": 0-d tensor, tokens generated so far,
    }

No processor reads a value back to the host or copies one to the device
while it runs, so ``generate()`` captures them in its decode step's CUDA
graph: masks of fixed token ids are built once per device, by fills, the
first time a processor runs (the prefill, outside any capture). The one
exception is ``PrefixConstrainedLogitsProcessor``, whose callback is Python
over host tokens, as in the JAX package.

Where the JAX processors build one-hots over the vocabulary
(``RepetitionPenalty`` [B, T, V], ``NoRepeatNGram`` [W, B, V]), these
scatter into a [B, V + 1] mask instead: column V takes the entries that
mark nothing.

Not ported: the encoder, Whisper, codebook and Bark processors, which wait
for the model families they belong to.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

NEG_INF = -1e9  # large but finite, so a softmax over filtered rows stays NaN-free


class LogitsProcessorList(list):
    def __call__(self, logits: torch.Tensor, state: dict) -> torch.Tensor:
        for proc in self:
            logits = proc(logits, state)
        return logits


def as_ids(x) -> tuple:
    """Token ids as a tuple of ints: from a list or tuple, one id, or None."""
    if x is None:
        return ()
    return tuple(int(t) for t in x) if isinstance(x, (list, tuple)) else (int(x),)


class _TokenMask:
    """A bool [V] mask of fixed token ids on the logits' device, built once per
    (device, V) by fills, so no host data is copied while a step runs."""

    def __init__(self, tokens: Sequence[int]):
        self.tokens = tuple(int(t) for t in tokens)
        self._built: dict = {}

    def __call__(self, logits: torch.Tensor) -> torch.Tensor:
        key = (logits.device, logits.shape[-1])
        mask = self._built.get(key)
        if mask is None:
            mask = torch.zeros(logits.shape[-1], dtype=torch.bool, device=logits.device)
            for t in self.tokens:
                mask.narrow(0, t, 1).fill_(True)
            self._built[key] = mask
        return mask


def _seen_mask(tokens: torch.Tensor, keep: torch.Tensor, vocab: int) -> torch.Tensor:
    """bool [B, V]: True at each token id that ``tokens`` [B, N] holds where
    ``keep`` [B, N] is set (a scatter; dropped entries go to column V)."""
    b = tokens.shape[0]
    idx = torch.where(keep, tokens.long(), vocab)
    seen = torch.zeros((b, vocab + 1), dtype=torch.bool, device=tokens.device)
    return seen.scatter_(1, idx, True)[:, :vocab]


def _tail(ids: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """The n tokens before slot ``pos`` [B, n], their slots clipped to the buffer."""
    idx = pos - n + torch.arange(n, device=ids.device)
    return ids.index_select(1, idx.clamp(0, ids.shape[1] - 1))


def _matches(window: torch.Tensor, seq: Sequence[int]) -> torch.Tensor:
    """bool [B]: ``window`` [B, n] equals ``seq`` (compared with host ints)."""
    match = torch.ones(window.shape[0], dtype=torch.bool, device=window.device)
    for i, t in enumerate(seq):
        match = match & (window[:, i] == t)
    return match


class TemperatureLogitsWarper:
    """reference logits_process.py TemperatureLogitsWarper"""

    def __init__(self, temperature: float):
        if temperature <= 0:
            raise ValueError(f"temperature must be > 0, got {temperature}")
        self.temperature = float(temperature)

    def __call__(self, logits, state):
        return logits / self.temperature


class TopKLogitsWarper:
    """Keep the top-k logits (reference TopKLogitsWarper)."""

    def __init__(self, top_k: int, filter_value: float = NEG_INF):
        self.top_k = int(top_k)
        self.filter_value = filter_value

    def __call__(self, logits, state):
        k = min(self.top_k, logits.shape[-1])
        if k <= 0:
            return logits
        threshold = torch.topk(logits, k, dim=-1).values[..., -1:]
        return logits.masked_fill(logits < threshold, self.filter_value)


class TopPLogitsWarper:
    """Nucleus sampling (reference TopPLogitsWarper): keep the tokens whose
    cumulative probability, counted before each one, is below top_p."""

    def __init__(self, top_p: float, filter_value: float = NEG_INF, min_tokens_to_keep: int = 1):
        self.top_p = float(top_p)
        self.filter_value = filter_value
        self.min_tokens_to_keep = min_tokens_to_keep

    def __call__(self, logits, state):
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (probs.cumsum(dim=-1) - probs) < self.top_p
        keep[..., :self.min_tokens_to_keep] = True
        threshold = torch.where(keep, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
        return logits.masked_fill(logits < threshold, self.filter_value)


class MinPLogitsWarper:
    """reference MinPLogitsWarper: keep tokens with p >= min_p * p_max."""

    def __init__(self, min_p: float, filter_value: float = NEG_INF):
        self.min_p = float(min_p)
        self.filter_value = filter_value

    def __call__(self, logits, state):
        probs = torch.softmax(logits, dim=-1)
        keep = probs >= self.min_p * probs.amax(dim=-1, keepdim=True)
        return torch.where(keep, logits, self.filter_value)


class RepetitionPenaltyLogitsProcessor:
    """reference RepetitionPenaltyLogitsProcessor: divide the positive logits of
    tokens seen in the valid slots by the penalty, multiply the negative ones."""

    def __init__(self, penalty: float):
        self.penalty = float(penalty)

    def __call__(self, logits, state):
        seen = _seen_mask(state["ids"], state["mask"] != 0, logits.shape[-1])
        penalized = torch.where(logits > 0, logits / self.penalty, logits * self.penalty)
        return torch.where(seen, penalized, logits)


class NoRepeatNGramLogitsProcessor:
    """n-gram blocking (reference NoRepeatNGramLogitsProcessor): token v is
    banned when the last n - 1 tokens before ``pos`` followed by v occurred
    before, in a window of valid slots that ends before ``pos``."""

    def __init__(self, ngram_size: int):
        self.n = int(ngram_size)

    def __call__(self, logits, state):
        n = self.n
        ids, mask, pos = state["ids"], state["mask"], state["pos"]
        b, t = ids.shape
        if n <= 0 or t < n:
            return logits
        # the n - 1 slots before pos; a negative slot counts from the end, as a
        # JAX gather reads it
        prefix = ids.index_select(1, (pos - (n - 1) + torch.arange(n - 1, device=ids.device)) % t)
        windows = ids.unfold(1, n, 1)  # [B, W, n]: the window at j covers ids[j : j + n]
        starts = torch.arange(t - n + 1, device=ids.device)
        match = ((windows[..., :n - 1] == prefix[:, None, :]).all(dim=-1)
                 & (mask.unfold(1, n, 1)[..., :n - 1] > 0).all(dim=-1)
                 & (starts + n - 1 < pos)[None, :])
        banned = _seen_mask(windows[..., n - 1], match, logits.shape[-1])
        return logits.masked_fill(banned, NEG_INF)


class MinNewTokensLengthLogitsProcessor:
    """Suppress EOS until ``min_new_tokens`` are generated (reference
    MinNewTokensLengthLogitsProcessor)."""

    def __init__(self, min_new_tokens: int, eos_token_ids: Sequence[int]):
        self.min_new_tokens = int(min_new_tokens)
        self.eos_token_ids = as_ids(eos_token_ids)
        self._eos = _TokenMask(self.eos_token_ids)

    def __call__(self, logits, state):
        block = state["gen_count"] < self.min_new_tokens
        return logits.masked_fill(block & self._eos(logits)[None, :], NEG_INF)


class SuppressTokensLogitsProcessor:
    """reference SuppressTokensLogitsProcessor."""

    def __init__(self, suppress_tokens: Sequence[int]):
        self.suppress = as_ids(suppress_tokens)
        self._mask = _TokenMask(self.suppress)

    def __call__(self, logits, state):
        return logits.masked_fill(self._mask(logits)[None, :], NEG_INF)


class SuppressTokensAtBeginLogitsProcessor:
    """reference SuppressTokensAtBeginLogitsProcessor: suppress at the step
    that generates token ``begin_index``."""

    def __init__(self, begin_suppress_tokens: Sequence[int], begin_index: int = 0):
        self.suppress = as_ids(begin_suppress_tokens)
        self.begin_index = begin_index
        self._mask = _TokenMask(self.suppress)

    def __call__(self, logits, state):
        at_begin = state["gen_count"] == self.begin_index
        return logits.masked_fill(at_begin & self._mask(logits)[None, :], NEG_INF)


def _only(logits, token_ids: Sequence[int]) -> torch.Tensor:
    """Logits that allow only ``token_ids``: NEG_INF elsewhere, 0 there."""
    forced = torch.full_like(logits, NEG_INF)
    for t in token_ids:
        forced.narrow(1, t, 1).fill_(0.0)
    return forced


class ForcedBOSTokenLogitsProcessor:
    """The first generated token is ``bos_token_id`` (reference
    ForcedBOSTokenLogitsProcessor)."""

    def __init__(self, bos_token_id: int):
        self.bos = int(bos_token_id)

    def __call__(self, logits, state):
        return torch.where(state["gen_count"] == 0, _only(logits, (self.bos,)), logits)


class ForcedEOSTokenLogitsProcessor:
    """The token generated at ``max_new_tokens - 1`` is ``eos_token_id``
    (reference ForcedEOSTokenLogitsProcessor)."""

    def __init__(self, max_new_tokens: int, eos_token_id: int):
        self.max_new_tokens = int(max_new_tokens)
        self.eos = int(eos_token_id)

    def __call__(self, logits, state):
        force = state["gen_count"] >= self.max_new_tokens - 1
        return torch.where(force, _only(logits, (self.eos,)), logits)


def _keep_top(logits, keep, k: int, filter_value: float) -> torch.Tensor:
    """``keep`` widened to the top ``k`` logits of each row, then filtered."""
    kth = torch.topk(logits, k, dim=-1).values[:, -1:]
    return torch.where(keep | (logits >= kth), logits, filter_value)


def _entropy(p, logp) -> torch.Tensor:
    """Each row's entropy [B, 1] from its probabilities and log-probabilities."""
    return -torch.where(p > 0, p * logp, 0.0).sum(dim=-1, keepdim=True)


class TypicalLogitsWarper:
    """Typical decoding (reference TypicalLogitsWarper)."""

    def __init__(self, mass: float = 0.9, filter_value: float = -float("inf")):
        self.mass = float(mass)
        self.filter_value = filter_value

    def __call__(self, logits, state=None):
        logp = torch.log_softmax(logits, dim=-1)
        p = logp.exp()
        ent = _entropy(p, logp)
        order = torch.argsort((-logp - ent).abs(), dim=-1, stable=True)
        cum = p.gather(1, order).cumsum(dim=-1)
        last = (cum < self.mass).sum(dim=-1, keepdim=True)
        sorted_keep = torch.arange(logits.shape[-1], device=logits.device)[None, :] <= last
        keep = torch.zeros_like(sorted_keep).scatter_(1, order, sorted_keep)
        return torch.where(keep, logits, self.filter_value)


class EpsilonLogitsWarper:
    """Epsilon sampling: drop tokens with probability below epsilon, keeping
    the top ``min_tokens_to_keep`` (reference EpsilonLogitsWarper)."""

    def __init__(self, epsilon: float, filter_value: float = -float("inf"),
                 min_tokens_to_keep: int = 1):
        self.epsilon = float(epsilon)
        self.filter_value = filter_value
        self.min_tokens_to_keep = min_tokens_to_keep

    def __call__(self, logits, state=None):
        keep = torch.softmax(logits, dim=-1) >= self.epsilon
        return _keep_top(logits, keep, self.min_tokens_to_keep, self.filter_value)


class EtaLogitsWarper:
    """Eta sampling: an entropy-adaptive epsilon (reference EtaLogitsWarper)."""

    def __init__(self, epsilon: float, filter_value: float = -float("inf"),
                 min_tokens_to_keep: int = 1):
        self.epsilon = float(epsilon)
        self.filter_value = filter_value
        self.min_tokens_to_keep = min_tokens_to_keep

    def __call__(self, logits, state=None):
        p = torch.softmax(logits, dim=-1)
        ent = _entropy(p, torch.log_softmax(logits, dim=-1))
        eta = (self.epsilon ** 0.5 * torch.exp(-ent)).clamp_max(self.epsilon)
        return _keep_top(logits, p >= eta, self.min_tokens_to_keep, self.filter_value)


class NoBadWordsLogitsProcessor:
    """Ban single-token bad words; a longer sequence bans its last token when
    the tokens before ``pos`` match the rest (reference
    NoBadWordsLogitsProcessor)."""

    def __init__(self, bad_words_ids, eos_token_id=None):
        self.singles = tuple(int(w[0]) for w in bad_words_ids if len(w) == 1)
        self.multi = tuple(tuple(int(t) for t in w) for w in bad_words_ids if len(w) > 1)
        self._singles = _TokenMask(self.singles)

    def __call__(self, logits, state=None):
        if self.singles:
            logits = logits.masked_fill(self._singles(logits)[None, :], -float("inf"))
        if self.multi and state is not None and "ids" in state:
            ids, pos = state["ids"], state["pos"]
            for seq in self.multi:
                n = len(seq) - 1
                match = _matches(_tail(ids, pos, n), seq[:-1]) & (pos >= n)
                banned = logits.clone()
                banned.narrow(1, seq[-1], 1).fill_(-float("inf"))
                logits = torch.where(match[:, None], banned, logits)
        return logits


class LogitNormalization:
    """log-softmax of the logits (reference LogitNormalization)."""

    def __call__(self, logits, state=None):
        return torch.log_softmax(logits, dim=-1)


class ExponentialDecayLengthPenalty:
    """Raise the EOS logits exponentially after ``start`` generated tokens
    (reference ExponentialDecayLengthPenalty)."""

    def __init__(self, exponential_decay_length_penalty, eos_token_id,
                 input_ids_seq_length: int = 0):
        self.start, self.factor = exponential_decay_length_penalty
        self.eos_ids = as_ids(eos_token_id)
        self.prompt_len = input_ids_seq_length

    def __call__(self, logits, state=None):
        gen_count = (state["gen_count"] if state is not None
                     else torch.zeros((), dtype=torch.int64, device=logits.device))
        mult = torch.pow(float(self.factor), (gen_count - self.start).clamp_min(0).float())
        logits = logits.clone()
        for e in self.eos_ids:
            logits[:, e] += logits[:, e].abs() * (mult - 1.0)
        return logits


class MinLengthLogitsProcessor:
    """Ban EOS while prompt + generated length is below ``min_length``
    (reference MinLengthLogitsProcessor)."""

    def __init__(self, min_length: int, eos_token_id, prompt_len: int = 0):
        self.min_length = int(min_length)
        self.eos_ids = as_ids(eos_token_id)
        self.prompt_len = int(prompt_len)
        self._eos = _TokenMask(self.eos_ids)

    def __call__(self, logits, state=None):
        if state is not None:
            too_short = (self.prompt_len + state["gen_count"]) < self.min_length
        else:
            too_short = self.prompt_len < self.min_length
        return torch.where(too_short & self._eos(logits)[None, :], NEG_INF, logits)


class InfNanRemoveLogitsProcessor:
    """nan -> 0, +inf -> the dtype's largest value, -inf -> NEG_INF (reference
    InfNanRemoveLogitsProcessor)."""

    def __call__(self, logits, state=None):
        return torch.nan_to_num(logits, nan=0.0, posinf=torch.finfo(logits.dtype).max,
                                neginf=NEG_INF)


class SequenceBiasLogitsProcessor:
    """Additive bias on token sequences (reference SequenceBiasLogitsProcessor):
    a single token is biased always; a longer sequence biases its last token
    when the tokens before ``pos`` match the rest."""

    def __init__(self, sequence_bias):
        items = sequence_bias.items() if isinstance(sequence_bias, dict) else sequence_bias
        self.singles = [(int(seq[0]), float(b)) for seq, b in items if len(seq) == 1]
        self.multi = [(tuple(int(t) for t in seq), float(b)) for seq, b in items if len(seq) > 1]

    def __call__(self, logits, state=None):
        logits = logits.clone()
        for tok, bias in self.singles:
            logits[:, tok] += bias
        if state is not None and "ids" in state:
            ids, pos = state["ids"], state["pos"]
            for seq, bias in self.multi:
                n = len(seq) - 1
                match = _matches(_tail(ids, pos, n), seq[:-1]) & (pos >= n)
                logits[:, seq[-1]] += torch.where(match, bias, 0.0)
        return logits


class ClassifierFreeGuidanceLogitsProcessor:
    """CFG over a doubled batch (reference ClassifierFreeGuidanceLogitsProcessor):
    rows [0:B] conditional, rows [B:2B] unconditional;
    out = uncond + scale * (cond - uncond)."""

    def __init__(self, guidance_scale: float):
        self.scale = float(guidance_scale)

    def __call__(self, logits, state=None):
        half = logits.shape[0] // 2
        cond, uncond = logits[:half], logits[half:]
        return uncond + self.scale * (cond - uncond)


class UnbatchedClassifierFreeGuidanceLogitsProcessor:
    """CFG through a second forward with the unconditional prompt (reference
    UnbatchedClassifierFreeGuidanceLogitsProcessor). The caller supplies
    ``get_unconditional_logits(state) -> [B, V]``, a closure over the model and
    the negative prompt."""

    def __init__(self, guidance_scale: float, get_unconditional_logits):
        self.scale = float(guidance_scale)
        self.get_unconditional_logits = get_unconditional_logits

    def __call__(self, logits, state=None):
        if self.scale == 1.0:
            return logits
        log_uncond = torch.log_softmax(self.get_unconditional_logits(state), dim=-1)
        log_cond = torch.log_softmax(logits, dim=-1)
        return log_uncond + self.scale * (log_cond - log_uncond)


class HammingDiversityLogitsProcessor:
    """Group beam search's diversity penalty (reference
    HammingDiversityLogitsProcessor): subtract ``diversity_penalty`` times
    each token's count among the tokens the previous beam groups chose at
    this step, ``state["current_tokens"]`` (ids outside the vocabulary count
    nowhere, as in the JAX one-hot)."""

    def __init__(self, diversity_penalty: float, num_beams: int, num_beam_groups: int):
        self.penalty = float(diversity_penalty)
        self.num_beams = num_beams
        self.num_beam_groups = num_beam_groups

    def __call__(self, logits, state):
        current = state.get("current_tokens") if isinstance(state, dict) else None
        if current is None or current.numel() == 0:
            return logits
        vocab = logits.shape[-1]
        current = current.reshape(-1).long()
        inside = (current >= 0) & (current < vocab)
        freq = torch.zeros(vocab, dtype=logits.dtype, device=logits.device).index_add_(
            0, torch.where(inside, current, 0), inside.to(logits.dtype))
        return logits - self.penalty * freq[None, :]


class PrefixConstrainedLogitsProcessor:
    """Constrained generation through a host callback (reference
    PrefixConstrainedLogitsProcessor): ``prefix_allowed_tokens_fn(batch_id,
    ids) -> list[int]`` over each row's valid tokens. Python over host tokens,
    so it reads the buffers back at every call and no graph can hold it, as
    in the JAX package."""

    def __init__(self, prefix_allowed_tokens_fn, num_beams: int = 1):
        self.fn = prefix_allowed_tokens_fn
        self.num_beams = num_beams

    def __call__(self, logits, state):
        ids, mask = state["ids"].cpu(), state["mask"].cpu()
        bias = torch.full(logits.shape, NEG_INF, dtype=torch.float32)
        for row in range(ids.shape[0]):
            allowed = self.fn(row // self.num_beams, ids[row][mask[row] > 0].numpy())
            bias[row, torch.as_tensor(allowed, dtype=torch.int64)] = 0.0
        return logits + bias.to(logits.device)


def processor_signature(processors: Optional[Sequence]) -> tuple:
    """What identifies a list of processors in a decode program's signature:
    each one's class and public settings (its device masks left out)."""
    return tuple((type(p).__name__, repr({k: v for k, v in vars(p).items()
                                          if not k.startswith("_")}))
                 for p in processors or ())
