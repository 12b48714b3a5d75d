"""Paged-attention model execution.

Port of ``transformers_tpu/generation/continuous_batching/model_runner.py``
(reference model_runner.py:29 ModelRunner). The JAX runner jits one program
per static bucket and donates the pools. Here the pools are updated in place,
prefill chunks run eagerly, and each decode bucket's step is one captured
device program on the card: a CUDA graph per (kind, bucket, sampling mode),
captured after one step run for real and replayed afterwards (``decode_step``
once per call, ``decode_multi`` once per step of its window); on the CPU the
same step functions run eagerly.

``PagedCacheView`` satisfies the cache interface the decoder attention
already uses (``update``/``layer``/``max_len``) but reads and writes paged
pools through block tables, so the model stack runs unchanged over paged KV:
a single-token step takes the paged decode kernel (``paged_layer``), a
prefill chunk attends over the gathered context (``layer``) through the
registry's flash kernel.

A decode call's host data (tables, tokens, positions, slots, and for
``decode_multi`` its EOS ids, budgets, sampling parameters and the window's
starting state) is packed into one pinned host buffer and copied to the
bucket's fixed device buffer with one non-blocking copy; the captured step
reads its inputs there. Argmax and sampling run on the device in every path.
``decode_multi`` runs K device steps with no host sync inside the window and
reads back once at its end.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ...ops.cuda_build import CountedGraph, read_back
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
        # contiguous for the flash kernel: a context of one page reshapes to a
        # view whose head and slot strides are still transposed
        k = pool_k[idx].transpose(2, 3).reshape(n, self.max_len, kvh, d).contiguous()
        v = pool_v[idx].transpose(2, 3).reshape(n, self.max_len, kvh, d).contiguous()
        return k, v


def _bucket(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()  # next power of two >= n


class _Staging:
    """Fixed inputs of one decode program: named fields packed in one host
    buffer (pinned on the card) and one device buffer of the same layout,
    each field a fixed view of both. ``upload`` writes the host fields and
    copies the whole buffer with one non-blocking copy."""

    def __init__(self, fields: dict, device: torch.device):
        offsets, total = {}, 0
        for name, (shape, dtype) in fields.items():
            nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            offsets[name] = (total, nbytes, shape, dtype)
            total += -(-nbytes // 16) * 16
        self.host = torch.zeros(total, dtype=torch.uint8, pin_memory=device.type == "cuda")
        self.device = torch.zeros(total, dtype=torch.uint8, device=device)
        self.host_fields = {n: self.host[o:o + b].view(dt).view(sh)
                            for n, (o, b, sh, dt) in offsets.items()}
        self.fields = {n: self.device[o:o + b].view(dt).view(sh)
                       for n, (o, b, sh, dt) in offsets.items()}
        self._copied = None  # the last copy's event: the host buffer is free once it is done

    def upload(self, values: dict) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        for name, value in values.items():
            self.host_fields[name].numpy()[...] = value
        self.device.copy_(self.host, non_blocking=True)
        if self.device.is_cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()


class _DecodeProgram:
    """One decode step over a bucket's fixed buffers (``staging.fields``):
    ``step(fields)`` returns the step's output. On the card the first ``run``
    runs it for real and captures it, later runs replay the graph."""

    def __init__(self, staging: _Staging, step: Callable, graph: bool):
        self.staging = staging
        self.step = step
        self.graph_wanted = graph
        self.graph = None
        self.out = None  # the graph's output, written by each replay

    def run(self, n: int = 1):
        """``n`` steps; returns the output of the last."""
        out = None
        if not self.graph_wanted:
            for _ in range(n):
                out = self.step(self.staging.fields)
            return out
        if self.graph is None:  # one step for real, then the capture
            graph = CountedGraph()
            out, self.out = graph.capture_after_run(lambda: self.step(self.staging.fields))
            self.graph, n = graph, n - 1
        for _ in range(n):
            self.graph.replay()
            out = self.out
        return out


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
        self._programs: dict = {}  # (kind, bucket, ...) -> _DecodeProgram
        self._capture = self.device.type == "cuda"  # decode steps as captured graphs

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

    def _program(self, key: tuple, fields: dict, step: Callable) -> _DecodeProgram:
        prog = self._programs.get(key)
        if prog is None:
            prog = _DecodeProgram(_Staging(fields, self.device), step, graph=self._capture)
            self._programs[key] = prog
        return prog

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

    def _decode_host(self, tokens, block_tables, positions, bucket: int) -> dict:
        """The host fields of a decode call: each row's block table, token,
        position and write slot; pad rows are all zeros (the null page)."""
        n = len(tokens)
        bs = self.block_size
        tables = np.zeros((bucket, self.max_blocks_per_seq), np.int32)
        for i, table in enumerate(block_tables):
            tables[i, : len(table)] = table
        toks = np.zeros(bucket, np.int64)
        pos = np.zeros(bucket, np.int64)
        toks[:n], pos[:n] = tokens, positions
        blk = tables[np.arange(bucket), np.minimum(pos // bs, self.max_blocks_per_seq - 1)]
        return {"tables": tables, "toks": toks, "pos": pos,
                "slots": (blk * bs + pos % bs).astype(np.int32)}

    def _decode_fields(self, bucket: int) -> dict:
        return {"tables": ((bucket, self.max_blocks_per_seq), torch.int32),
                "toks": ((bucket,), torch.int64), "pos": ((bucket,), torch.int64),
                "slots": ((bucket,), torch.int32)}

    def _step_logits(self, f: dict) -> torch.Tensor:
        """One decode step's logits [bucket, V] from the fields of a decode call."""
        ctx = (f["pos"] + 1).to(torch.int32)
        view = self._view(f["tables"], f["slots"][:, None], ctx)
        return self._forward(f["toks"][:, None], f["pos"][:, None], view, ctx)

    @torch.inference_mode()
    def decode_step(self, tokens, block_tables: list[list[int]], positions):
        """One decode step for N sequences. tokens [N], positions [N] (the slot
        each token goes to). Returns logits [N, V] (device).

        N is padded up to a power-of-two bucket, so a varying live batch maps
        onto a handful of shapes, each one captured step on the card (the
        reference's CUDA-graph-per-bucket discipline). Pad rows write to the
        null block and read ctx_len = 1 there."""
        n = len(tokens)
        bucket = _bucket(n)
        prog = self._program(("step", bucket), self._decode_fields(bucket), self._step_logits)
        prog.staging.upload(self._decode_host(tokens, block_tables, positions, bucket))
        logits = prog.run()
        self.decode_steps += 1
        return logits[:n].clone()

    @torch.inference_mode()
    def sample(self, logits: torch.Tensor, reqs, counts) -> list[int]:
        """Next token of each request from its logits row (device argmax or
        the counter-based sampler); the one host read of a step."""
        sampling = RowSampling.from_requests(reqs, counts, self.device)
        return sample_tokens(logits, sampling).tolist()

    def _window_step(self, filtered) -> Callable:
        """One step of ``decode_multi``'s window over its fields; ``filtered``:
        None when every row is greedy, else whether some row filters with
        top-k or top-p."""
        bs, maxb = self.block_size, self.max_blocks_per_seq

        def step(f):
            toks, pos, finished, commits = f["toks"], f["pos"], f["finished"], f["commits"]
            sampling = None if filtered is None else RowSampling(
                temperature=f["temperature"], top_k=f["top_k"], top_p=f["top_p"],
                seed=f["seed"], count=f["count"], filtered=filtered)
            is_eos = (toks[:, None] == f["eos"]).any(dim=-1)
            do_write = ~finished & ~is_eos
            blk = f["tables"].gather(1, (pos // bs).clamp_max(maxb - 1)[:, None])[:, 0]
            slots = torch.where(do_write, blk * bs + pos % bs, 0).to(torch.int32)
            ctx = torch.where(do_write, pos + 1, 1).to(torch.int32)
            logits = self._forward(toks[:, None], pos[:, None],
                                   self._view(f["tables"], slots[:, None], ctx), ctx)
            committed_now = ~finished
            commits += committed_now.long()
            count = f["count"] + commits if sampling is not None else None
            nxt = sample_tokens(logits, sampling, count=count)
            f["out"].index_copy_(1, f["step"], torch.where(committed_now, toks, -1)[:, None])
            finished |= is_eos | (commits >= f["budget"])
            toks.copy_(torch.where(finished, toks, nxt))
            pos += do_write.long()
            f["step"] += 1

        return step

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
        The window's state (tokens, positions, ``finished``, commits, the
        output columns and the step index) lives in the bucket's fixed buffers,
        set by the one upload and advanced on the device by each step.
        Returns (committed [N, steps] with -1 padding, pending [N],
        n_committed [N], finished [N]) as numpy arrays, from one read back."""
        n = len(tokens)
        bucket = _bucket(n)
        steps = int(min(k, max(budgets)))
        e = max([len(x) for x in eos_lists] + [1])
        sampling = RowSampling.host_values(reqs, counts, rows=bucket)
        filtered = None if sampling is None else sampling.pop("filtered")
        fields = dict(self._decode_fields(bucket), eos=((bucket, e), torch.int64),
                      budget=((bucket,), torch.int64), finished=((bucket,), torch.bool),
                      commits=((bucket,), torch.int64), out=((bucket, k), torch.int64),
                      step=((1,), torch.int64))
        if sampling is not None:
            fields.update(temperature=((bucket,), torch.float32), top_p=((bucket,), torch.float32),
                          top_k=((bucket,), torch.int64), seed=((bucket,), torch.int64),
                          count=((bucket,), torch.int64))
        prog = self._program(("window", bucket, e, k, filtered), fields,
                             self._window_step(filtered))
        host = self._decode_host(tokens, block_tables, positions, bucket)
        eos = np.full((bucket, e), -1, np.int64)
        for i, ids in enumerate(eos_lists):
            eos[i, : len(ids)] = ids
        budget = np.zeros(bucket, np.int64)  # pad rows: budget 0, finished from the start
        budget[:n] = budgets
        host.update(eos=eos, budget=budget, finished=budget <= 0, commits=0, out=-1, step=0,
                    **(sampling or {}))
        prog.staging.upload(host)
        prog.run(steps)
        self.decode_steps += steps
        f = prog.staging.fields
        result = read_back(torch.cat([f["out"], f["toks"][:, None], f["commits"][:, None],
                                      f["finished"][:, None].long()], dim=1)).numpy()
        return result[:n, :steps], result[:n, -3], result[:n, -2], result[:n, -1].astype(bool)
