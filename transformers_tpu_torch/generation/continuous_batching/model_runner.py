"""Paged-attention model execution.

Port of ``transformers_tpu/generation/continuous_batching/model_runner.py``
(reference model_runner.py:29 ModelRunner). The JAX runner jits one program
per static bucket and donates the pools; here the model runs eagerly and the
pools are updated in place.

``PagedCacheView`` satisfies the cache interface the decoder attention
already uses (``update``/``layer``/``max_len``) but reads and writes paged
pools through block tables, so the model stack runs unchanged over paged KV:
a single-token step takes the paged decode kernel (``paged_layer``), a
prefill chunk attends over the gathered context (``layer``) through the
registry's flash kernel.

Every step's host data (tokens, positions, slots, block tables) goes to the
device as one packed int32 tensor. Argmax and sampling run on the device in
every path. ``decode_multi`` runs K device steps with no host sync inside the
window and reads back once at its end.
"""

from __future__ import annotations

import numpy as np
import torch

from .cache import PagedKVCache
from .sampling import RowSampling, sample_tokens


class PagedCacheView:
    """Paged pools exposed as a per-step cache (``layout == "paged"``).

    - ``write_slots`` [N, S]: flat pool slot (block * block_size + offset) of
      every incoming token; slot 0 (the null block) absorbs padding.
    - ``ctx_lens`` [N]: live context length per row AFTER this step's tokens,
      the paged decode kernel's per-row read bound.
    - ``block_tables`` [N, MAXB]; ``max_len`` = MAXB * block_size, the length
      of the context ``layer()`` gathers.
    """

    layout = "paged"

    def __init__(self, keys, values, block_tables, write_slots, ctx_lens, block_size: int):
        self.keys = keys
        self.values = values
        self.block_tables = block_tables
        self.ctx_lens = ctx_lens
        self.block_size = block_size
        self.max_len = block_tables.shape[1] * block_size
        # (block, offset) of every incoming token, shared by all layers
        slots = write_slots.reshape(-1).long()
        self._write_blocks = slots // block_size
        self._write_offsets = slots % block_size

    def update(self, layer_idx, k, v, cache_position=None) -> None:
        """Scatter k/v [N, S, KVH, D] into their (block, offset) pool slots, in
        place. Pad tokens all write slot 0 of the null page."""
        kvh, d = k.shape[2], k.shape[3]
        blks, offs = self._write_blocks, self._write_offsets
        pool_k, pool_v = self.keys[layer_idx], self.values[layer_idx]
        pool_k[blks, :, offs] = k.reshape(-1, kvh, d).to(pool_k.dtype)
        pool_v[blks, :, offs] = v.reshape(-1, kvh, d).to(pool_v.dtype)

    def paged_layer(self, layer_idx):
        """(k_pool, v_pool, block_tables, ctx_lens) for the decode kernel."""
        return self.keys[layer_idx], self.values[layer_idx], self.block_tables, self.ctx_lens

    def layer(self, layer_idx):
        """The context gathered contiguous, [N, max_len, KVH, D] each for k and
        v (chunked prefill, and decode shapes the kernel does not take)."""
        pool_k, pool_v = self.keys[layer_idx], self.values[layer_idx]
        n = self.block_tables.shape[0]
        kvh, d = pool_k.shape[1], pool_k.shape[3]
        idx = self.block_tables.long()
        k = pool_k[idx].transpose(2, 3).reshape(n, self.max_len, kvh, d)
        v = pool_v[idx].transpose(2, 3).reshape(n, self.max_len, kvh, d)
        return k, v


def _bucket(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()  # next power of two >= n


class ModelRunner:
    """Runs prefill chunks and decode steps over the paged pools (reference
    model_runner.py:29). Counts the device work it launched: ``prefill_chunks``
    (multi-token chunks, which attend through the flash kernel),
    ``single_token_chunks`` (one-token chunks, which take the paged decode
    kernel like a decode step), ``prefill_tokens`` and ``decode_steps``."""

    def __init__(self, model, cache: PagedKVCache, *, max_blocks_per_seq: int):
        self.model = model
        self.cache = cache
        self.max_blocks_per_seq = max_blocks_per_seq
        self.block_size = cache.block_size
        self.max_len = max_blocks_per_seq * cache.block_size
        self.device = cache.keys[0].device
        self.prefill_chunks = 0
        self.single_token_chunks = 0
        self.prefill_tokens = 0
        self.decode_steps = 0

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _view(self, block_tables, write_slots, ctx_lens) -> PagedCacheView:
        return PagedCacheView(self.cache.keys, self.cache.values, block_tables, write_slots,
                              ctx_lens, self.block_size)

    def _forward(self, input_ids, positions, view: PagedCacheView, ctx_lens):
        """The model over the view; logits of each row's last token [N, V].
        ``positions`` [N, S]: rope and causal positions of the tokens."""
        slots = torch.arange(view.max_len, dtype=torch.int32, device=self.device)
        kv_valid = (slots[None, :] < ctx_lens[:, None]).to(torch.int32)
        out = self.model(input_ids=input_ids, attention_mask=kv_valid, position_ids=positions,
                         past_key_values=view, cache_position=positions[:, :1],
                         logits_to_keep=1)
        return out.logits[:, -1]

    # --------------------------------------------------------------- public
    @torch.inference_mode()
    def prefill_chunk(self, input_ids: list[int], block_table: list[int], start: int):
        """Run one prompt chunk of ONE sequence: tokens at positions ``start ..
        start + len - 1``. Returns the logits of its last token [V] (device).
        The gathered context covers only the pages the chunk's context spans."""
        real = len(input_ids)
        ctx = start + real
        bs = self.block_size
        nb = -(-ctx // bs)
        table = np.asarray(block_table[:nb], np.int64)
        pos = np.arange(start, ctx, dtype=np.int64)
        slots = table[pos // bs] * bs + pos % bs
        packed = self._to_device(np.concatenate(
            [np.asarray(input_ids, np.int64), pos, slots, table, [ctx]]).astype(np.int32))
        ids, pos_t, slots_t = packed[:real], packed[real:2 * real], packed[2 * real:3 * real]
        bt, ctx_t = packed[3 * real:3 * real + nb], packed[-1:]
        view = self._view(bt[None], slots_t[None], ctx_t)
        logits = self._forward(ids[None].long(), pos_t[None].long(), view, ctx_t)
        if real > 1:
            self.prefill_chunks += 1
        else:
            self.single_token_chunks += 1
        self.prefill_tokens += real
        return logits[0]

    def _decode_inputs(self, tokens, block_tables, positions, bucket: int):
        """Pack [bucket, MAXB + 3] int32: the block table, token, position and
        write slot of every row; pad rows are all zeros (the null page)."""
        n = len(tokens)
        bs = self.block_size
        host = np.zeros((bucket, self.max_blocks_per_seq + 3), np.int32)
        for i, table in enumerate(block_tables):
            host[i, : len(table)] = table
        host[:n, -3] = tokens
        host[:n, -2] = positions
        pos = np.asarray(positions, np.int64)
        blk = host[np.arange(n), np.minimum(pos // bs, self.max_blocks_per_seq - 1)]
        host[:n, -1] = blk * bs + pos % bs
        dev = self._to_device(host)
        # the tables contiguous once here, not per layer in the kernel's wrapper
        return dev[:, :-3].contiguous(), dev[:, -3].long(), dev[:, -2].long(), dev[:, -1]

    @torch.inference_mode()
    def decode_step(self, tokens, block_tables: list[list[int]], positions):
        """One decode step for N sequences. tokens [N], positions [N] (the slot
        each token goes to). Returns logits [N, V] (device).

        N is padded up to a power-of-two bucket, so a varying live batch maps
        onto a handful of shapes (the reference's CUDA-graph-per-bucket
        discipline; a graph per bucket can be captured over this later). Pad
        rows write to the null block and read ctx_len = 1 there."""
        n = len(tokens)
        bt, toks, pos, slots = self._decode_inputs(tokens, block_tables, positions, _bucket(n))
        ctx = (pos + 1).to(torch.int32)
        view = self._view(bt, slots[:, None], ctx)
        logits = self._forward(toks[:, None], pos[:, None], view, ctx)
        self.decode_steps += 1
        return logits[:n]

    @torch.inference_mode()
    def sample(self, logits: torch.Tensor, reqs, counts) -> list[int]:
        """Next token of each request from its logits row (device argmax or
        the counter-based sampler); the one host read of a step."""
        sampling = RowSampling.from_requests(reqs, counts, self.device)
        return sample_tokens(logits, sampling).tolist()

    @torch.inference_mode()
    def decode_multi(self, tokens, block_tables: list[list[int]], positions, budgets,
                     eos_lists: list[tuple], reqs, counts, k: int):
        """Up to ``k`` decode steps for N sequences with no host sync inside
        the window (the JAX ``while_loop`` of ``decode_multi``). Per-row
        semantics match the single-step engine:

        - the entry ``tokens`` are each row's pending token; a pending EOS is
          committed WITHOUT a cache write and the row finishes;
        - otherwise the pending token is written at its position and the next
          token sampled (argmax, or the counter-based draw at the row's
          temperature with count = tokens committed so far);
        - a row finishes when its committed count reaches its budget;
          finished rows write the null page and their results are masked.

        The window runs min(k, largest budget) steps: no row commits more.
        Returns (committed [N, steps] with -1 padding, pending [N],
        n_committed [N], finished [N]) as numpy arrays, from one read back."""
        n = len(tokens)
        bucket = _bucket(n)
        steps = int(min(k, max(budgets)))
        bs = self.block_size
        bt, toks, pos, _ = self._decode_inputs(tokens, block_tables, positions, bucket)
        e = max([len(x) for x in eos_lists] + [1])
        host = np.full((bucket, e + 1), -1, np.int64)
        host[:, -1] = 0  # pad rows: budget 0, finished from the start
        host[:n, -1] = budgets
        for i, ids in enumerate(eos_lists):
            host[i, : len(ids)] = ids
        small = self._to_device(host)
        eos, budget = small[:, :-1], small[:, -1]
        sampling = RowSampling.from_requests(reqs, counts, self.device, rows=bucket)
        base_count = (sampling.count if sampling is not None
                      else torch.zeros((bucket,), dtype=torch.int64, device=self.device))

        out = torch.full((bucket, steps), -1, dtype=torch.int64, device=self.device)
        commits = torch.zeros((bucket,), dtype=torch.int64, device=self.device)
        finished = budget <= 0
        for i in range(steps):
            is_eos = (toks[:, None] == eos).any(dim=-1)
            do_write = ~finished & ~is_eos
            blk = bt.gather(1, (pos // bs).clamp_max(self.max_blocks_per_seq - 1)[:, None])[:, 0]
            slots = torch.where(do_write, blk * bs + pos % bs, 0).to(torch.int32)
            ctx = torch.where(do_write, pos + 1, 1).to(torch.int32)
            view = self._view(bt, slots[:, None], ctx)
            logits = self._forward(toks[:, None], pos[:, None], view, ctx)
            committed_now = ~finished
            commits = commits + committed_now.long()
            nxt = sample_tokens(logits, sampling, count=base_count + commits)
            out[:, i] = torch.where(committed_now, toks, -1)
            finished = finished | is_eos | (commits >= budget)
            toks = torch.where(finished, toks, nxt)
            pos = pos + do_write.long()
            self.decode_steps += 1
        result = torch.cat([out, toks[:, None], commits[:, None], finished[:, None].long()],
                           dim=1).cpu().numpy()
        return result[:n, :steps], result[:n, -3], result[:n, -2], result[:n, -1].astype(bool)
