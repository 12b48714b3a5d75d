"""Request lifecycle + scheduling.

Port of ``transformers_tpu/generation/continuous_batching/scheduler.py``
(reference generation/continuous_batching/requests.py and scheduler.py: :331
FIFOScheduler, :380 PrefillFirstScheduler, chunked prefill + token budget
:122-208). Host-side logic only; device work happens in ModelRunner.

Two differences from the JAX scheduler: a prompt whose every token is already
in the prefix cache would leave nothing to prefill and never produce its
first token, so the prefix match stops one token short of the cached ids;
and a request whose context exceeds ``max_blocks_per_seq`` stays in
``waiting`` as FAILED, where the engine's step reports it, instead of being
dropped unreported (its submitter would wait forever).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class RequestStatus(str, Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    FAILED = "failed"


@dataclass
class RequestState:
    """reference continuous_batching/requests.py RequestState."""

    request_id: str
    prompt_ids: list[int]
    max_new_tokens: int = 32
    eos_token_ids: tuple = ()
    temperature: float = 0.0  # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    status: RequestStatus = RequestStatus.WAITING
    block_table: list[int] = field(default_factory=list)
    prefilled: int = 0            # prompt tokens already written to cache
    generated_ids: list[int] = field(default_factory=list)
    pending_token: Optional[int] = None  # sampled, not yet written to cache
    error: Optional[str] = None

    # host swap slots while offloaded (offloading_manager.py)
    swap_slots: Optional[list] = None

    @property
    def context_len(self) -> int:
        return len(self.prompt_ids) + len(self.generated_ids)

    @property
    def cache_ids(self) -> list[int]:
        """Every token whose KV must be in cache: prompt + committed
        generations (a soft-reset request re-prefills both)."""
        return list(self.prompt_ids) + list(self.generated_ids)

    def is_done(self) -> bool:
        if self.pending_token is not None and self.pending_token in self.eos_token_ids:
            return True
        return len(self.generated_ids) >= self.max_new_tokens


@dataclass
class SchedulerOutput:
    prefill: Optional[RequestState] = None      # one chunked-prefill victim
    prefill_chunk: int = 0                       # tokens of its prompt to run
    decode: list[RequestState] = field(default_factory=list)


class FIFOScheduler:
    """Decode-first with chunked prefill under a token budget (reference
    scheduler.py:331; PrefillFirstScheduler flips the priority :380)."""

    prefill_first = False

    def __init__(self, block_manager, *, block_size: int, token_budget: int = 128,
                 max_batch: int = 64, max_blocks_per_seq: int = 64):
        self.bm = block_manager
        self.block_size = block_size
        self.token_budget = token_budget
        self.max_batch = max_batch
        self.max_blocks_per_seq = max_blocks_per_seq
        self.waiting: list[RequestState] = []
        self.active: list[RequestState] = []

    def add(self, req: RequestState):
        self.waiting.append(req)

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    def _try_admit(self) -> Optional[RequestState]:
        """Allocate blocks (reusing cached prefixes) for the next waiting
        request; defer if the pool can't hold its full context."""
        if not self.waiting:
            return None
        req = self.waiting[0]
        total = len(req.prompt_ids) + req.max_new_tokens
        needed_blocks = -(-total // self.block_size)
        if needed_blocks > self.max_blocks_per_seq:
            req.status = RequestStatus.FAILED
            req.error = f"context {total} exceeds max {self.max_blocks_per_seq * self.block_size}"
            return None  # left in ``waiting``: the engine's step reports it and drops it
        # the last token is always prefilled: its logits give the first token
        shared, matched = self.bm.match_prefix(req.cache_ids[:-1])
        fresh = self.bm.allocate(needed_blocks - len(shared))
        if fresh is None:
            self.bm.free(shared)  # give back the refcounts; retry later
            return None
        self.waiting.pop(0)
        req.block_table = shared + fresh
        req.prefilled = matched
        req.status = RequestStatus.PREFILLING
        return req

    def schedule(self) -> SchedulerOutput:
        out = SchedulerOutput()
        # admit new work while there is room
        if len(self.active) < self.max_batch:
            admitted = self._try_admit()
            if admitted is not None:
                self.active.append(admitted)
        # one prefilling request per step, chunked by the token budget
        for req in self.active:
            if req.status == RequestStatus.PREFILLING:
                remaining = len(req.cache_ids) - req.prefilled
                out.prefill = req
                out.prefill_chunk = min(remaining, self.token_budget)
                break
        decoding = [r for r in self.active if r.status == RequestStatus.DECODING]
        out.decode = decoding[: self.max_batch]
        return out

    def finish(self, req: RequestState, status=RequestStatus.FINISHED):
        req.status = status
        if req.block_table:
            # publish full prompt blocks for prefix reuse, then drop our refs
            self.bm.register_full_blocks(req.prompt_ids, req.block_table)
            self.bm.free(req.block_table)
            req.block_table = []
        if req in self.active:
            self.active.remove(req)


class PrefillFirstScheduler(FIFOScheduler):
    prefill_first = True

    def schedule(self) -> SchedulerOutput:
        out = super().schedule()
        if out.prefill is not None and self.prefill_first:
            out.decode = []  # dedicate the step to prefill
        return out
