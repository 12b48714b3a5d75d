"""Paged KV cache + block manager.

Port of ``transformers_tpu/generation/continuous_batching/cache.py``
(reference generation/continuous_batching/cache.py:89 ``PagedAttentionCache``
and cache_manager.py:37/:58 ``BlockManager`` with prefix sharing). Device
state is one pair of page pools per layer, ``[num_blocks, KVH, block_size,
D]``, so one page of one kv head is a contiguous ``[block_size, D]`` slab,
which the paged decode kernel (ops/paged_attention.py) reads. Block 0 is the
null page: padding writes land there and no live slot reads it.

Unlike the JAX cache, which is immutable and replaced after every step, the
pools are updated IN PLACE, as the port's ``StaticKVCache`` is. All
allocation bookkeeping (free list, prefix hash table, refcounts) is host-side
Python, as in the reference.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class PagedKVCache:
    """Per-layer page pools; block 0 is reserved as the null page."""

    keys: list    # num_layers x [num_blocks, KVH, block_size, D]
    values: list
    block_size: int
    num_blocks: int

    @property
    def num_layers(self):
        return len(self.keys)


def init_paged_cache(*, num_layers: int, num_blocks: int, block_size: int,
                     num_kv_heads: int, head_dim: int, dtype=torch.bfloat16,
                     device=None) -> PagedKVCache:
    shape = (num_blocks, num_kv_heads, block_size, head_dim)
    keys = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)]
    values = [torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)]
    return PagedKVCache(keys=keys, values=values, block_size=block_size, num_blocks=num_blocks)


class BlockManager:
    """Host-side page allocator with prefix-cache reuse (reference
    cache_manager.py:58: hash chains of full blocks -> block ids, refcounted)."""

    def __init__(self, num_blocks: int, block_size: int):
        # block 0 reserved as the null/padding page
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.free_blocks: list[int] = list(range(num_blocks - 1, 0, -1))
        self.ref_counts: dict[int, int] = {}
        # prefix cache: chain-hash -> block id (only FULL blocks are cached)
        self.prefix_table: dict[bytes, int] = {}
        self.block_hash: dict[int, bytes] = {}
        # refcount-0 blocks whose content stays matchable until evicted
        # (reference cache_manager.py keeps cached pages until reallocation)
        self.cached_free: list[int] = []

    @property
    def num_free_blocks(self) -> int:
        return len(self.free_blocks) + len(self.cached_free)

    @staticmethod
    def _chain_hash(prev: bytes, tokens: tuple[int, ...]) -> bytes:
        return hashlib.sha256(prev + np.asarray(tokens, np.int32).tobytes()).digest()

    def match_prefix(self, token_ids: list[int]) -> tuple[list[int], int]:
        """Longest cached full-block prefix -> (block ids, matched tokens).
        Matched blocks get their refcount bumped (shared pages)."""
        blocks: list[int] = []
        h = b""
        matched = 0
        for start in range(0, len(token_ids) - self.block_size + 1, self.block_size):
            chunk = tuple(token_ids[start : start + self.block_size])
            if len(chunk) < self.block_size:
                break
            h = self._chain_hash(h, chunk)
            blk = self.prefix_table.get(h)
            if blk is None:
                break
            blocks.append(blk)
            matched += self.block_size
        for blk in blocks:
            if self.ref_counts.get(blk, 0) == 0 and blk in self.cached_free:
                self.cached_free.remove(blk)  # revived from the evictable pool
            self.ref_counts[blk] = self.ref_counts.get(blk, 0) + 1
        return blocks, matched

    def allocate(self, n: int) -> Optional[list[int]]:
        """n fresh blocks or None if the pool is exhausted (caller backoff —
        reference scheduler defers the request). Evicts cached-free blocks
        (oldest first) when the plain free list runs dry."""
        if self.num_free_blocks < n:
            return None
        out = []
        for _ in range(n):
            if self.free_blocks:
                blk = self.free_blocks.pop()
            else:
                blk = self.cached_free.pop(0)
                h = self.block_hash.pop(blk, None)
                if h is not None and self.prefix_table.get(h) == blk:
                    del self.prefix_table[h]
            out.append(blk)
            self.ref_counts[blk] = 1
        return out

    def register_full_blocks(self, token_ids: list[int], blocks: list[int]):
        """Publish full blocks into the prefix cache after prefill."""
        h = b""
        for i, blk in enumerate(blocks):
            start = i * self.block_size
            chunk = tuple(token_ids[start : start + self.block_size])
            if len(chunk) < self.block_size:
                break
            h = self._chain_hash(h, chunk)
            if h not in self.prefix_table:
                self.prefix_table[h] = blk
                self.block_hash[blk] = h

    def free(self, blocks: list[int]):
        for blk in blocks:
            rc = self.ref_counts.get(blk, 0) - 1
            if rc > 0:
                self.ref_counts[blk] = rc
                continue
            self.ref_counts.pop(blk, None)
            if blk in self.block_hash:
                # cached content stays matchable until evicted by allocate()
                self.cached_free.append(blk)
            else:
                self.free_blocks.append(blk)
