"""Continuous batching engine + user API.

Port of ``transformers_tpu/generation/continuous_batching/continuous_api.py``
(reference generation/continuous_batching/continuous_api.py:
``ContinuousMixin.generate_batch`` :1083/:1202, ``ContinuousBatchingManager``
:553 background thread, OutputRouter :84).

The engine loop each step:
1. the scheduler admits and chunks work (host);
2. the ModelRunner runs a prefill chunk and a batched decode step, or K
   decode steps, over the paged pools (device);
3. tokens are sampled on the device (sampling.py) and routed to their
   requests (host).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import traceback
from dataclasses import dataclass, field
from typing import Iterable, Optional

from .cache import BlockManager, init_paged_cache
from .model_runner import ModelRunner
from .offloading_manager import OffloadingManager
from .scheduler import FIFOScheduler, PrefillFirstScheduler, RequestState, RequestStatus

logger = logging.getLogger(__name__)


@dataclass
class GenerationOutput:
    request_id: str
    prompt_ids: list
    generated_ids: list = field(default_factory=list)
    status: str = "finished"
    error: Optional[str] = None
    new_token: Optional[int] = None  # set on streaming deliveries


class ContinuousBatchingEngine:
    """Synchronous core; the Manager wraps it in a thread.

    The pools hold ``num_key_value_heads`` keys and values of ``head_dim``
    per token, as the JAX engine's do. A model whose cache holds something
    else (multi-head latent attention's latents: ``paged_kv_cache`` False) is
    refused here; the JAX engine takes it and fails at its first cache write."""

    def __init__(self, model, *, num_blocks: int = 256, block_size: int = 32,
                 max_batch: int = 16, token_budget: int = 64,
                 max_context: Optional[int] = None, scheduler: str = "fifo",
                 cache_dtype=None, swap_blocks: int = 0,
                 steps_per_sync: int = 1):
        if not getattr(model, "paged_kv_cache", True):
            raise NotImplementedError(
                f"{type(model).__name__} caches latents, not per-head keys and values "
                "(multi-head latent attention): the paged pools hold num_key_value_heads x "
                "head_dim per token, and continuous batching does not take it; use generate()")
        self.model = model
        config = model.config
        if hasattr(config, "get_text_config"):
            config = config.get_text_config()
        num_kv = getattr(config, "num_key_value_heads", None) or config.num_attention_heads
        head_dim = (getattr(config, "head_dim", None)
                    or config.hidden_size // config.num_attention_heads)
        max_context = max_context or min(config.max_position_embeddings, num_blocks * block_size)
        max_blocks_per_seq = -(-max_context // block_size)
        cache = init_paged_cache(
            num_layers=config.num_hidden_layers, num_blocks=num_blocks, block_size=block_size,
            num_kv_heads=num_kv, head_dim=head_dim, dtype=cache_dtype or model.dtype,
            device=model.device)
        self.bm = BlockManager(num_blocks, block_size)
        sched_cls = PrefillFirstScheduler if scheduler == "prefill_first" else FIFOScheduler
        self.scheduler = sched_cls(self.bm, block_size=block_size, token_budget=token_budget,
                                   max_batch=max_batch, max_blocks_per_seq=max_blocks_per_seq)
        self.runner = ModelRunner(model, cache, max_blocks_per_seq=max_blocks_per_seq)
        self.offloader = OffloadingManager(cache, self.bm, swap_blocks=swap_blocks)
        self.token_budget = token_budget
        # >1: run K decode steps per host sync (ModelRunner.decode_multi).
        # Falls back to single steps when a prefill is scheduled, a request is
        # offloaded, or a request needs top-k/top-p sampling.
        self.steps_per_sync = max(1, int(steps_per_sync))

    def add_request(self, req: RequestState):
        self.scheduler.add(req)

    def cancel_request(self, request_id: str) -> Optional[GenerationOutput]:
        """Drop a request wherever it lives (waiting/active/offloaded),
        freeing its blocks; returns a 'cancelled' delivery event or None if
        the id is unknown (already finished)."""
        for r in list(self.scheduler.waiting):
            if r.request_id == request_id:
                self.scheduler.waiting.remove(r)
                return self._cancelled(r)
        for r in list(self.scheduler.active):
            if r.request_id == request_id:
                self.scheduler.finish(r, RequestStatus.FAILED)
                return self._cancelled(r)
        for r in list(self.offloader.offloaded):
            if r.request_id == request_id:
                self.offloader.release(r)
                return self._cancelled(r)
        return None

    @staticmethod
    def _cancelled(r: RequestState) -> GenerationOutput:
        return GenerationOutput(request_id=r.request_id, prompt_ids=r.prompt_ids,
                                generated_ids=list(r.generated_ids), status="cancelled")

    def has_work(self) -> bool:
        return self.scheduler.has_work() or bool(self.offloader.offloaded)

    def step(self) -> list[GenerationOutput]:
        """One scheduler step; returns per-request deliveries (new tokens and
        finishes)."""
        out_events: list[GenerationOutput] = []
        # re-admit offloaded victims first (reference offloading_manager.py)
        restored = self.offloader.try_restore(self.runner)
        if restored is not None:
            self.scheduler.active.append(restored)
        plan = self.scheduler.schedule()
        # preempt a decode victim when admission is blocked by POOL pressure
        # (a max_batch cap is not pressure: preempting for it would starve a
        # healthy decoding request)
        if (self.scheduler.waiting and plan.prefill is None
                and len(self.scheduler.active) < self.scheduler.max_batch
                and not self.offloader.offloaded
                and self.scheduler.waiting[0].status == RequestStatus.WAITING):
            victims = [r for r in self.scheduler.active
                       if r.status == RequestStatus.DECODING]
            if victims:
                victim = victims[-1]
                self.scheduler.active.remove(victim)
                self.offloader.offload(victim, self.runner)
                plan = self.scheduler.schedule()

        # surface admission failures
        for req in list(self.scheduler.waiting):
            if req.status == RequestStatus.FAILED:
                self.scheduler.waiting.remove(req)
                out_events.append(GenerationOutput(
                    request_id=req.request_id, prompt_ids=req.prompt_ids,
                    status="failed", error=req.error))

        # ---- chunked prefill (one victim per step, reference scheduler.py:122)
        if plan.prefill is not None and plan.prefill_chunk > 0:
            req = plan.prefill
            cache_ids = req.cache_ids
            chunk_ids = cache_ids[req.prefilled : req.prefilled + plan.prefill_chunk]
            logits = self.runner.prefill_chunk(chunk_ids, req.block_table, req.prefilled)
            req.prefilled += len(chunk_ids)
            if req.prefilled >= len(cache_ids):
                if req.pending_token is not None:
                    # soft-reset resume: the next token was already sampled
                    # before preemption; nothing to sample here
                    req.status = RequestStatus.DECODING
                    return out_events
                tok = self.runner.sample(logits[None], [req], [len(req.generated_ids)])[0]
                req.pending_token = tok
                req.status = RequestStatus.DECODING
                if req.is_done():
                    # an immediate EOS is still part of the output
                    if tok in req.eos_token_ids and len(req.generated_ids) < req.max_new_tokens:
                        req.generated_ids.append(tok)
                    self._finish(req, out_events)
                else:
                    out_events.append(GenerationOutput(
                        request_id=req.request_id, prompt_ids=req.prompt_ids,
                        generated_ids=list(req.generated_ids) + [tok],
                        status="decoding", new_token=tok))

        # ---- batched decode
        decode = [r for r in plan.decode if r.pending_token is not None]
        # multi-step window: no prefill scheduled THIS step (a waiting queue
        # with no prefill means admission is capacity-blocked, and batch or
        # block space frees only at a sync anyway), nothing offloaded, and
        # every row greedy or pure-temperature
        if (decode and self.steps_per_sync > 1 and plan.prefill is None
                and not self.offloader.offloaded
                and all((not r.top_k or r.top_k <= 0)
                        and (not r.top_p or r.top_p >= 1.0) for r in decode)):
            self._decode_multi(decode, out_events)
            return out_events
        if decode:
            logits = self.runner.decode_step([r.pending_token for r in decode],
                                             [r.block_table for r in decode],
                                             [r.context_len for r in decode])
            for r in decode:
                r.generated_ids.append(int(r.pending_token))
            toks = self.runner.sample(logits, decode, [len(r.generated_ids) for r in decode])
            for r, tok in zip(decode, toks):
                r.pending_token = tok
                if r.is_done():
                    # a trailing EOS still counts as generated (parity with
                    # generate(): eos is appended then decoding stops)
                    if tok in r.eos_token_ids and len(r.generated_ids) < r.max_new_tokens:
                        r.generated_ids.append(tok)
                    self._finish(r, out_events)
                else:
                    out_events.append(GenerationOutput(
                        request_id=r.request_id, prompt_ids=r.prompt_ids,
                        generated_ids=list(r.generated_ids), status="decoding", new_token=tok))
        return out_events

    def _decode_multi(self, decode: list[RequestState], out_events: list):
        """K decode steps per host sync (ModelRunner.decode_multi); per-request
        commit/EOS/budget semantics mirror the single-step path."""
        committed, pending, commits, finished = self.runner.decode_multi(
            [r.pending_token for r in decode], [r.block_table for r in decode],
            [r.context_len for r in decode],
            [r.max_new_tokens - len(r.generated_ids) for r in decode],
            [tuple(r.eos_token_ids) for r in decode], decode,
            [len(r.generated_ids) for r in decode], self.steps_per_sync)
        for i, r in enumerate(decode):
            toks = [int(t) for t in committed[i][: int(commits[i])] if t >= 0]
            r.generated_ids.extend(toks)
            if finished[i]:
                r.pending_token = None
                self._finish(r, out_events)
            else:
                r.pending_token = int(pending[i])
                out_events.append(GenerationOutput(
                    request_id=r.request_id, prompt_ids=r.prompt_ids,
                    generated_ids=list(r.generated_ids), status="decoding",
                    new_token=toks[-1] if toks else None))

    def _finish(self, req: RequestState, out_events: list):
        self.scheduler.finish(req)
        out_events.append(GenerationOutput(
            request_id=req.request_id, prompt_ids=req.prompt_ids,
            generated_ids=list(req.generated_ids), status="finished"))

    def run_to_completion(self) -> dict[str, GenerationOutput]:
        results: dict[str, GenerationOutput] = {}
        while self.has_work():
            for ev in self.step():
                if ev.status in ("finished", "failed"):
                    results[ev.request_id] = ev
        return results


class ContinuousBatchingManager:
    """Background-thread wrapper with request/output queues (reference
    continuous_api.py:553)."""

    def __init__(self, model, **engine_kwargs):
        self.engine = ContinuousBatchingEngine(model, **engine_kwargs)
        self._in: queue.Queue = queue.Queue()
        self._cancels: queue.Queue = queue.Queue()
        self._outs: dict[str, queue.Queue] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._error: Optional[str] = None
        # ids of the latest requests cancelled while still live
        self.cancelled: collections.deque = collections.deque(maxlen=256)

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True, name="cb-manager")
        self._thread.start()

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def submit(self, req: RequestState) -> queue.Queue:
        """Enqueue a request; returns its delivery queue (stream of
        GenerationOutput, last one has status finished/failed/cancelled)."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            self._outs[req.request_id] = q
        self._in.put(req)
        return q

    def cancel(self, request_id: str) -> None:
        """Request cancellation (client disconnect / timeout); processed by
        the engine thread at its next loop iteration."""
        self._cancels.put(request_id)

    def _loop(self):
        # Cross-thread failure propagation (reference continuous_api.py:131
        # BackgroundThreadStatus): any step error fails every live request.
        while not self._stop.is_set():
            try:
                while True:
                    try:
                        self.engine.add_request(self._in.get_nowait())
                    except queue.Empty:
                        break
                while True:
                    try:
                        rid = self._cancels.get_nowait()
                    except queue.Empty:
                        break
                    ev = self.engine.cancel_request(rid)
                    if ev is not None:
                        self.cancelled.append(rid)
                    with self._lock:
                        q = self._outs.pop(rid, None)
                    if q is not None:
                        q.put(ev or GenerationOutput(request_id=rid, prompt_ids=[],
                                                     status="cancelled"))
                if not self.engine.has_work():
                    self._stop.wait(0.005)
                    continue
                for ev in self.engine.step():
                    q = self._outs.get(ev.request_id)
                    if q is not None:
                        q.put(ev)
                        if ev.status in ("finished", "failed"):
                            with self._lock:
                                self._outs.pop(ev.request_id, None)
            except Exception as exc:  # noqa: BLE001
                self._error = traceback.format_exc()
                logger.error(f"continuous batching loop failed: {exc}\n{self._error}")
                with self._lock:
                    for rid, q in self._outs.items():
                        q.put(GenerationOutput(request_id=rid, prompt_ids=[],
                                               status="failed", error=str(exc)))
                    self._outs.clear()
                # drop all engine state for the failed batch
                for r in list(self.engine.scheduler.active):
                    self.engine.scheduler.finish(r, RequestStatus.FAILED)
                self.engine.scheduler.waiting.clear()


class ContinuousMixin:
    """Adds generate_batch to generative models (reference
    continuous_api.py:1083)."""

    def init_continuous_batching(self, **engine_kwargs) -> ContinuousBatchingManager:
        return ContinuousBatchingManager(self, **engine_kwargs)

    def generate_batch(self, inputs: Iterable[list[int]], *, max_new_tokens: int = 32,
                       temperature: float = 0.0, seed: int = 0,
                       **engine_kwargs) -> list[list[int]]:
        """Synchronous batch generation over the CB engine; returns generated
        ids per prompt (reference generate_batch :1202)."""
        engine = ContinuousBatchingEngine(self, **engine_kwargs)
        eos = getattr(self.config, "eos_token_id", None)
        if eos is None:
            eos_ids = ()
        else:
            eos_ids = tuple(eos) if isinstance(eos, (list, tuple)) else (eos,)
        reqs = []
        for i, prompt in enumerate(inputs):
            req = RequestState(request_id=f"req-{i}", prompt_ids=list(map(int, prompt)),
                               max_new_tokens=max_new_tokens, eos_token_ids=eos_ids,
                               temperature=temperature, seed=seed + i)
            engine.add_request(req)
            reqs.append(req)
        results = engine.run_to_completion()
        return [results[r.request_id].generated_ids if results[r.request_id].status == "finished"
                else [] for r in reqs]
