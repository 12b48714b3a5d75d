"""Request offloading for continuous batching.

Port of ``transformers_tpu/generation/continuous_batching/offloading_manager.py``
(reference offloading_manager.py:55 OffloadingManager): when the device page
pool cannot admit new work, a decoding victim is preempted by either

1. **host offload**: its live pages are copied into a host swap pool,
   preallocated once (pinned when the pools are on a CUDA card), and the
   device blocks freed; restoring copies the pages back into freshly
   allocated blocks. Exact state is preserved, like the reference's
   pinned-CPU pool (:20-23).
2. **soft reset**: when the swap pool is also full, the pages are dropped;
   the request re-prefills over ``prompt + generated`` when readmitted
   (:19-21). The sampled-but-unwritten ``pending_token`` is kept, so the
   continuation is identical for greedy decoding.

The swap pool is tracked with a free list: no host allocation at run time
(reference :22-23).
"""

from __future__ import annotations

import logging
from typing import Optional

import torch

from .scheduler import RequestState, RequestStatus

logger = logging.getLogger(__name__)


class OffloadingManager:
    def __init__(self, cache, block_manager, *, swap_blocks: int = 0):
        self.bm = block_manager
        self.swap_blocks = swap_blocks
        self.offloaded: list[RequestState] = []
        if swap_blocks:
            k0 = cache.keys[0]
            shape = (swap_blocks,) + tuple(k0.shape[1:])
            pin = k0.device.type == "cuda"
            self._swap_k = [torch.zeros(shape, dtype=k0.dtype, pin_memory=pin)
                            for _ in cache.keys]
            self._swap_v = [torch.zeros(shape, dtype=k0.dtype, pin_memory=pin)
                            for _ in cache.values]
            self._free_slots = list(range(swap_blocks - 1, -1, -1))
        else:
            self._swap_k = self._swap_v = None
            self._free_slots = []

    # ------------------------------------------------------------- offload
    def offload(self, req: RequestState, runner) -> str:
        """Preempt ``req``; returns the strategy used ("swap" or "reset")."""
        blocks = list(req.block_table)
        n_live = -(-req.context_len // self.bm.block_size) if req.context_len else 0
        live = blocks[:n_live]
        if self._swap_k is not None and len(self._free_slots) >= len(live):
            slots = [self._free_slots.pop() for _ in live]
            cache = runner.cache
            idx = torch.tensor(live, dtype=torch.long, device=cache.keys[0].device)
            dst = torch.tensor(slots, dtype=torch.long)
            for layer in range(len(cache.keys)):
                self._swap_k[layer][dst] = cache.keys[layer][idx].cpu()
                self._swap_v[layer][dst] = cache.values[layer][idx].cpu()
            req.swap_slots = slots
            strategy = "swap"
        else:
            req.swap_slots = None
            strategy = "reset"
            req.prefilled = 0  # re-prefill prompt+generated on readmission
        self.bm.free(req.block_table)
        req.block_table = []
        req.status = RequestStatus.WAITING
        self.offloaded.append(req)
        logger.info(f"offloaded request {req.request_id} via {strategy}")
        return strategy

    # ------------------------------------------------------------- restore
    def try_restore(self, runner) -> Optional[RequestState]:
        """Re-admit the oldest offloaded request if blocks are available."""
        if not self.offloaded:
            return None
        req = self.offloaded[0]
        total = req.context_len + (req.max_new_tokens - len(req.generated_ids))
        needed = -(-total // self.bm.block_size)
        blocks = self.bm.allocate(needed)
        if blocks is None:
            return None
        self.offloaded.pop(0)
        req.block_table = blocks
        if req.swap_slots is not None:
            slots = req.swap_slots
            cache = runner.cache
            dev = cache.keys[0].device
            idx = torch.tensor(blocks[: len(slots)], dtype=torch.long, device=dev)
            src = torch.tensor(slots, dtype=torch.long)
            for layer in range(len(cache.keys)):
                cache.keys[layer][idx] = self._swap_k[layer][src].to(dev)
                cache.values[layer][idx] = self._swap_v[layer][src].to(dev)
            self._free_slots.extend(slots)
            req.swap_slots = None
            req.status = RequestStatus.DECODING
        else:
            # soft reset: re-prefill prompt + generated from scratch
            req.prefilled = 0
            req.status = RequestStatus.PREFILLING
        logger.info(f"restored request {req.request_id}")
        return req

    def release(self, req: RequestState):
        """Free swap slots when an offloaded request is cancelled/failed."""
        if req.swap_slots:
            self._free_slots.extend(req.swap_slots)
            req.swap_slots = None
        if req in self.offloaded:
            self.offloaded.remove(req)
