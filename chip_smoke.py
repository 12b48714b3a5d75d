#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``transformers_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

(a) build every CUDA kernel from ``transformers_tpu_torch/csrc`` (one nvcc per
    source, all at once), print the card's name and power limit, and each
    tensor-core flash-forward and split-KV decode build's (K2, K6, K7)
    registers, shared memory and spills from ``nvcc -Xptxas -v``, and those
    of the quantized product's builds (Q1, Q2) by name; a K2 or K7 build
    that spills fails the run;
(b) hold each kernel against its plain PyTorch version at the main paths'
    shapes, in bf16, and time the kernel, the plain version and one PyTorch
    library call that computes the same function (a yardstick only: the port
    never calls it), beside the least time the card could take; then hold
    them on the cases of the reference's tests/ops files in float32, float16
    and bf16, at head_dim 64, 128 and 256. The fused decode (K2, split-KV)
    is also held on a long context (S = 4096, pos = 4000) relative to the
    outputs' scale too, run twice (bitwise-equal outputs required), timed
    with idle splits (pos 300 of 4096 slots against 320), and replayed from
    a CUDA graph at two other slots set on the card. The static-cache decode
    kernel (K7, which no path of the JAX package runs) is held at the
    Llama-3-8B decode geometry over a ragged BSHD cache, on live ranges of
    2000-4000 slots (relative hold, bitwise double run) and on the
    reference's cases; its launches are those checks, and every path's count
    of it must stay 0. The flash backward (K5 dQ, K4
    dK/dV) is held at the training shapes (4 rows of 2048 tokens, right-padded,
    32 heads over 8 kv heads, head_dim 128, bf16; causal, windowed, softcapped)
    and timed against SDPA's backward; the flash forward (K1) is held and
    timed at those training shapes too, beside SDPA's forward. The paged
    decode (K6, split-KV, with its merge kernel) is also held on contexts of
    2000-4000 slots and run twice at the continuous-batching shape (the
    outputs must be equal bit for bit). The weight-only quantized product
    (Q1 ``quantized_matmul`` from the codes, Q2 ``widen_codes`` then
    ``torch.mm``) is held against the plain ``quantized_dot`` for int8, int4
    and fp8 codes x bf16, f16 and f32 activations at the four Llama-3-8B
    projection shapes and 1, 3, 8 and 16 rows (Q2 also 256), plus int4 rows
    with a tail past the last whole tile; Q1 is timed at 8 and 16 rows beside
    its bound, bf16 ``F.linear`` and the plain versions, each weight read
    from device memory, and Q1 and Q2's route are swept over 1-64 rows (the
    sweep that set ``ROW_THRESHOLD``);
(c) the static-cache path at the Llama-3-8B geometry in bf16 with random
    weights from ``--seed``: a full-width, 2-layer checkpoint written with the
    port's safetensors writer and read back by ``from_pretrained``; then
    ``generate`` (batch 8, prompt 128, 32 new tokens, greedy) on the 32-layer
    model, its decode step replayed from a captured CUDA graph, against the
    uncaptured step loop on the same inputs: ids bitwise equal, the kernels'
    launch counts checked per layer for both, the graph's calls run under
    ``torch.cuda.set_sync_debug_mode("error")``; prefill ms, decode ms/step,
    tokens/s and the profiler's idle share of both, the capture's time and
    the memory the captured program holds; then sampled at one seed (top-k,
    top-p) and greedy with repetition penalty, no-repeat n-gram and min new
    tokens, each graph against the step loop, bitwise; then the generated
    tokens teacher-forced through the plain path;
(d) the continuous-batching path on the same 32-layer model: the engine
    (block size 32, 8 resident requests, 128-token prefill budget, 320 pages)
    serves 16 requests with prompts of 64-512 tokens from ``--seed``, four of
    them sharing a 256-token prefix, 64 new tokens each, greedy, with a host
    sync every step and every 16 steps, each by an engine whose decode steps
    replay captured graphs and by one that runs them uncaptured (each engine
    first serves the same traffic with shifted token ids, which captures its
    graphs on the same schedule); the two engines' tokens must be equal for
    every request, the graph engines' decode calls run under the sync-debug
    check; launch counts checked against the engine's own count of prefill
    chunks and decode steps; a few finished requests teacher-forced through
    the plain path;
(f) (run after (d), while its model is alive) weight-only quantization: the
    32-layer model's weights quantized to int8 on the card, the JAX bench's
    serving leg: ``generate`` at batch 16 (prompt 128 left-padded by PADS
    twice over, 32 new tokens, greedy), graph against the uncaptured step
    loop bitwise with exact launches (Q1 224 per decode step from the
    replays, Q2 224 per prefill, K2 32 per step), no Q2 and no dense copy of
    a quantized weight in the decode step; int8 and bf16 (the same weights)
    at batch 16 timed in turns and profiled; the int8 path's teacher-forced
    logits held to the plain path against a float32 run of the same codes;
    phase (d)'s traffic through int8 engines (graph and uncaptured, 16
    steps per sync), tokens equal, launches exact per decode step and
    prefill chunk; then 4 layers of the same width with int4 and fp8
    weights (graph against step loop, logits held) and with int8 weights
    over the int8 KV cache (``cache_implementation="quantized"``);
(e) training at the same width, depth cut to 4 layers (f32 weights, bf16
    compute, random from ``--seed``), after (c)/(d)'s model is freed: layer 0's
    q/k/v gradients and the loss of one row through the kernel path held
    against the plain bf16 path and a float32 run; then ``Trainer.train()``,
    AdamW, 5 steps over 4 rows of 1536-2048 tokens, with launch counts (K1,
    K4 and K5 once per layer per step), step time, tokens/s, MFU, peak
    memory and a profiled step; then one step with gradient checkpointing
    (K1 twice per layer).

Prints one ``{"kernels": [...]}`` line, the smoke's total seconds, the card's
name and power limit, and ends with ``{"ok": true, "device": {...}}``. Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak

# Llama-3-8B geometry (bench.py)
GEOMETRY = dict(vocab_size=128256, hidden_size=4096, intermediate_size=14336,
                num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
                head_dim=128, tie_word_embeddings=False, rms_norm_eps=1e-5,
                rope_theta=500000.0)
BATCH, PROMPT, NEW = 8, 128, 32
# left padding of each prompt row (slots of the 128 that are pad)
PADS = (0, 3, 17, 0, 40, 1, 0, 64)
# continuous batching (phase d): engine settings, and the traffic
CB_ENGINE = dict(block_size=32, max_batch=8, token_budget=128, num_blocks=320, max_context=640)
CB_REQUESTS, CB_NEW, CB_PREFIX = 16, 64, 256
CB_SHARED = (0, 8, 11, 14)  # requests that open with the shared prefix
# training (phase e, and the backward kernels' shapes in phase b)
TRAIN_LAYERS, TRAIN_ROWS, TRAIN_SEQ, TRAIN_STEPS, TRAIN_MIN_LEN = 4, 4, 2048, 5, 1536

# Kernel vs plain: both compute in f32 from the same inputs and round the
# output once to the storage type; sums run in another order, so outputs of
# magnitude up to ~4 differ by about one step of that type (bf16 2^-8, f16
# 2^-11 relative), and in f32 by a few ulps of the sums.
TOLERANCE = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 2e-5}
# The backward is held element by element, each gradient value against its own
# size: |kernel - plain| <= u * |plain| + u/2 * rms(plain). Both sides compute
# in f32 (the tensor-core kernels take P and dS as hi + lo operand pairs that
# carry ~16 bits; rounded once, they read 8-12x this rule's bound at the
# training shape) and round once, so two nearly equal f32 values round at
# most one unit in the last place apart: u = 2^-7 of the value in bf16 (8 significant bits),
# 2^-10 in f16; in f32 they differ only by the order of the sums. The rms term
# covers values that are small through cancellation. A single tolerance over
# the whole tensor would not do: gradients are sums over Sq (dK, dV) or Skv
# (dQ), and under causality the first slots' dK/dV are many times the rest.
GRAD_ULP = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10, torch.float32: 2e-5}
KERNEL_ATOL = TOLERANCE[torch.bfloat16]
LSE_ATOL = 1e-3  # f32 logsumexp from the same scores

# The cases of tests/ops/test_flash_attention.py and tests/ops/test_fused_decode.py
# (which the CPU tests hold the plain versions to), plus head_dim 256 and 64
# cases, run in every storage type the kernels are built for.
FLASH_OPS_CASES = {  # name: (b, sq, skv, h, kvh, d, left pads, window, cap)
    "causal_128_128": (2, 128, 128, 4, 2, 64, None, None, None),
    "causal_64_256": (2, 64, 256, 4, 2, 64, None, None, None),
    "causal_100_300": (2, 100, 300, 4, 2, 64, None, None, None),
    "padded_kv": (2, 64, 192, 4, 4, 64, (40, 10), None, None),
    "sliding_window": (1, 256, 256, 2, 2, 64, None, 64, None),
    "logit_cap": (1, 128, 128, 2, 2, 64, None, None, 30.0),
    "gqa_d128": (2, 128, 128, 4, 2, 128, None, None, None),
    "d256_padded_window": (2, 96, 160, 4, 1, 256, (17, 0), 40, None),
}
# The cases of test_flash_bwd_kernel_parity (GQA, kv holes, window 37, softcap
# 30) and test_flash_grad_matches_eager; the backward also runs FLASH_OPS_CASES.
FLASH_BWD_CASES = {  # name: (b, sq, skv, h, kvh, d, left pads, window, cap)
    "bwd_gqa_holes": (2, 128, 192, 4, 2, 64, (0, 23), None, None),
    "bwd_gqa_holes_window_37": (2, 128, 192, 4, 2, 64, (0, 23), 37, None),
    "bwd_gqa_holes_cap_30": (2, 128, 192, 4, 2, 64, (0, 23), None, 30.0),
    "bwd_grad_matches_eager": (1, 64, 64, 2, 2, 64, None, None, None),
}
DECODE_OPS_CASES = {  # name: (b, h, kvh, d, s, pos, starts, hole fraction)
    "gqa_1": (3, 4, 4, 128, 64, 41, None, 0),
    "gqa_4": (3, 8, 2, 128, 64, 41, None, 0),
    "gqa_8": (3, 16, 2, 128, 64, 41, None, 0),
    "first_token": (2, 8, 4, 128, 64, 0, None, 0),
    "left_padding_starts": (3, 8, 2, 128, 64, 50, [0, 7, 23], 0),
    "mask_holes": (2, 4, 4, 128, 64, 30, None, 0.1),
    "bf16_case": (4, 8, 2, 128, 128, 100, None, 0),
    "chunked_long_context": (4, 8, 8, 128, 1536, 1200, [0, 100, 511, 512], 0),
    "bench_geometry": (8, 32, 8, 128, 224, 192, None, 0),
    "d64_gqa_6": (2, 12, 2, 64, 96, 70, [5, 0], 0),
    "d256_gqa_8": (2, 8, 1, 256, 80, 79, [3, 0], 0.05),
    "d64_gqa_2": (2, 4, 2, 64, 96, 95, [0, 40], 0),
    "d256_gqa_4": (2, 8, 2, 256, 100, 99, [0, 33], 0.05),
}
# K7: the cases of tests/ops/test_decode_attention.py, plus GQA 1 and 8,
# head_dim 64 and 256 and a row whose end lies before its start
STATIC_DECODE_OPS_CASES = {  # name: (b, s, h, kvh, d, starts, ends, window)
    "matches_eager": (2, 512, 8, 2, 128, (0, 64), (300, 400), None),
    "sliding_window": (2, 512, 8, 2, 128, (0, 0), (500, 200), 128),
    "small_context": (1, 256, 8, 2, 128, (0,), (5,), None),
    "gqa_1": (2, 256, 4, 4, 128, (3, 0), (200, 77), None),
    "gqa_8": (2, 256, 16, 2, 128, (0, 31), (256, 140), 64),
    "head_dim_64": (2, 256, 8, 2, 64, (10, 0), (250, 33), None),
    "head_dim_256": (2, 128, 4, 1, 256, (0, 17), (128, 90), 40),
    "end_before_start": (2, 512, 8, 2, 128, (300, 7), (200, 411), None),
    "head_dim_64_gqa_8": (2, 256, 16, 2, 64, (0, 5), (256, 120), None),
    "head_dim_256_gqa_8": (2, 192, 8, 1, 256, (2, 0), (190, 64), 100),
}
PAGED_OPS_CASES = {  # name: (n, h, kvh, d, block size, ctx_lens, window)
    "gqa_1": (3, 8, 8, 128, 16, (40, 16, 61), None),
    "gqa_4": (3, 8, 2, 128, 16, (40, 16, 61), None),
    "gqa_8": (3, 16, 2, 128, 16, (40, 16, 61), None),
    "single_token_context": (2, 4, 4, 128, 16, (1, 33), None),
    "many_page_groups": (2, 8, 2, 128, 16, (296, 219), None),
    "ragged": (5, 8, 4, 128, 32, (32, 1, 317, 64, 200), None),
    "head_dim_64": (5, 8, 4, 64, 32, (32, 1, 317, 64, 200), None),
    "window_16": (3, 8, 2, 128, 16, (100, 48, 32), 16),
    "window_40": (3, 8, 2, 128, 16, (100, 48, 32), 40),
    "window_128": (3, 8, 2, 128, 16, (100, 48, 32), 128),
    "bf16_long_context_sliding": (2, 16, 2, 128, 32, (521, 77), 200),
    "ctx_0": (2, 8, 2, 128, 16, (0, 40), None),
    "gqa_16": (2, 32, 2, 128, 32, (90, 33), None),
    "d64_gqa_8": (3, 16, 2, 64, 16, (40, 1, 77), None),
    "d256_gqa_2": (3, 4, 2, 256, 32, (100, 33, 1), 40),
    "d256_gqa_8": (2, 8, 1, 256, 16, (64, 130), None),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of ``fn``: ``iters`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events. The graph takes the
    host's launch cost out, which at these sizes exceeds the kernels' own
    time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


# --------------------------------------------------------------------- (a)
# the builds this script reports one by one (the others as a summary per library)
REPORTED_BUILDS = ("flash_fwd_tc_kernel", "paged_split_kernel", "paged_combine_kernel",
                   "fused_decode_kernel", "static_decode_kernel")
# the builds reported as one line each (one instantiation per code type,
# activation type and row tile)
SUMMED_BUILDS = ("quantized_linear_kernel", "widen_codes_kernel")
# the split-KV decode builds (K2, K7) must not spill
NO_SPILL_BUILDS = ("fused_decode_kernel", "static_decode_kernel")


def _demangle(names: list) -> dict:
    """Readable kernel names (``cu++filt`` or ``c++filt``, else as they are),
    without their parameter lists."""
    tool = shutil.which("cu++filt") or shutil.which("/usr/local/cuda/bin/cu++filt") \
        or shutil.which("c++filt")
    plain = names
    if tool and names:
        try:
            plain = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                                   check=True, timeout=60).stdout.splitlines()
        except (OSError, subprocess.SubprocessError):
            plain = names
    if len(plain) != len(names):
        plain = names
    short = [re.sub(r"\(anonymous namespace\)::|<unnamed>::|\(int\)|^void ", "", p).split("(")[0]
             for p in plain]
    return dict(zip(names, short))


def ptxas_builds(log: str) -> list:
    """(kernel, registers, static shared bytes, spill bytes) of each entry
    function in an ``nvcc -Xptxas -v`` log."""
    builds, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"name": m.group(1), "regs": 0, "smem": 0, "spill": 0}
            builds.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    names = _demangle([b["name"] for b in builds])
    for b in builds:
        b["name"] = names[b["name"]]
    return builds


def phase_build() -> dict:
    from transformers_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    secs = time.perf_counter() - t0
    for name in cuda_build.KERNELS:
        log = cuda_build.library_path(name).with_suffix(".log").read_text()
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        smem = [int(m) for m in re.findall(r"(\d+) bytes smem", log)] or [0]
        spills = sum(int(m) for m in re.findall(r"(\d+) bytes spill", log))
        print(f"[build] {name}: {len(regs)} kernels, registers {min(regs)}-{max(regs)}, "
              f"static smem up to {max(smem)} bytes, spill bytes {spills}")
        builds = ptxas_builds(log)
        for kernel in SUMMED_BUILDS:
            group = [b for b in builds if kernel in b["name"]]
            if group:
                print(f"[build]   {kernel}: {len(group)} instantiations, registers "
                      f"{min(b['regs'] for b in group)}-{max(b['regs'] for b in group)}, spill "
                      f"bytes {sum(b['spill'] for b in group)} (in "
                      f"{sum(1 for b in group if b['spill'])} of them)")
        for b in builds:
            if any(k in b["name"] for k in REPORTED_BUILDS):
                print(f"[build]   {b['name']}: {b['regs']} registers, static smem {b['smem']} "
                      f"bytes, spill bytes {b['spill']}")
            if b["spill"] and any(k in b["name"] for k in NO_SPILL_BUILDS):
                raise AssertionError(f"{b['name']} spills {b['spill']} bytes")
    print(f"[build] kernels built in {secs:.1f} s")
    return {"build_s": secs}


# --------------------------------------------------------------------- (b)
def _flash_inputs(gen, *, b=8, sq=128, skv=128, h=32, kvh=8, d=128, pads=None,
                  dtype=torch.bfloat16):
    """Queries occupy the last ``sq`` slots of a ``skv``-slot timeline."""
    dev = "cuda"
    q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, skv, kvh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, skv, kvh, d), generator=gen, device=dev).to(dtype)
    qpos = (skv - sq + torch.arange(sq, dtype=torch.int32, device=dev)).expand(b, sq)
    valid = torch.ones((b, skv), dtype=torch.int32, device=dev)
    for row, p in enumerate(pads or ()):
        valid[row, :p] = 0
    return q, k, v, qpos.contiguous(), valid


def _flash_errors(q, k, v, qpos, valid, **kw) -> tuple[float, float]:
    """Max abs error of the kernel's output and logsumexp against the plain
    version's; raises if the two disagree on which rows see no slot."""
    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_plain)

    out, lse = flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, return_lse=True, **kw)
    ref, ref_lse = flash_attention_plain(q, k, v, qpos, valid, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref_lse)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError("flash: fully masked rows differ")
    return max_err(out, ref), max_err(lse[fin], ref_lse[fin])


def check_flash(gen) -> dict:
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_plain)

    cases = {
        "causal": dict(),
        "left_padded": dict(pads=PADS),
        "window_softcap": dict(pads=PADS, window=48, cap=30.0),
    }
    result = None
    for name, c in cases.items():
        q, k, v, qpos, valid = _flash_inputs(gen, pads=c.get("pads"))
        kw = dict(scale=q.shape[-1] ** -0.5, is_causal=True,
                  sliding_window=c.get("window"), logit_cap=c.get("cap"))
        err, lse_err = _flash_errors(q, k, v, qpos, valid, **kw)
        ok = err <= KERNEL_ATOL and lse_err <= LSE_ATOL
        print(f"[flash] {name}: max_abs_err out {err:.3e} (tol {KERNEL_ATOL}) "
              f"lse {lse_err:.3e} (tol {LSE_ATOL})")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version ({name})")
        if name != "left_padded":
            continue
        # the main path's case: time it
        b, s, h, d = q.shape
        ms = device_ms(lambda: flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, **kw))
        plain_ms = device_ms(lambda: flash_attention_plain(q, k, v, qpos, valid, **kw))
        slots = torch.arange(s, device="cuda")
        mask = (valid != 0)[:, None, :] & (slots[None, None, :] <= qpos[:, :, None])
        qt, kt, vt, m4 = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4, scale=kw["scale"], enable_gqa=True))
        visible = int(mask.sum())
        nbytes = (q.numel() * 2 + k.numel() + v.numel()) * 2 + b * h * s * 4 \
            + (qpos.numel() + valid.numel()) * 4  # q, k, v and out; lse; mask data
        bms, by = bound_ms(nbytes, 4.0 * d * h * visible)
        result = dict(name="flash_fwd", route="cuda",
                      source="transformers_tpu_torch/csrc/flash_fwd.cu",
                      replaces="transformers_tpu/ops/pallas/flash_attention.py:190",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=library_ms)
        print(f"[flash] B={b} S={s} H={h} KVH={k.shape[2]} D={d}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return result


def event_ms(fn, iters: int = 5) -> float:
    """Device time of one call of ``fn`` between CUDA events over ``iters``
    calls, after one warm-up call: for calls of a millisecond or more, where
    the host's launch cost is small beside the device's time."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 320) -> float:
    """Host microseconds per call of ``fn``: the best of three runs of
    ``calls`` back-to-back calls, from an idle card to the last call's return.
    For a kernel whose launch costs the host more than the card's time, this
    is the host's cost of one call."""
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e6 / calls)
    torch.cuda.synchronize()
    return best


def grad_ratio(a: torch.Tensor, ref: torch.Tensor, u: float) -> float:
    """Largest |a - ref| / (u * |ref| + u/2 * rms(ref)) over the elements: at
    most 1 where ``a`` holds ``ref`` to GRAD_ULP's bound."""
    a, ref = a.float(), ref.float()
    rms = ref.square().mean().sqrt()
    return float(((a - ref).abs() / (u * ref.abs() + 0.5 * u * rms).clamp_min(1e-30)).max())


def _bwd_errors(q, k, v, qpos, valid, do, **kw) -> tuple[dict, dict]:
    """K5 and K4 against the plain backward on the kernel forward's output
    and logsumexp: per gradient, the max abs error and the worst ratio of
    ``grad_ratio`` (at most 1 to pass). The kernels' dV comes back under
    ``"dv_tensors"`` with the plain one, for the planted-fault check."""
    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_bwd_plain,
                                                            flash_bwd_dkv, flash_bwd_dq)

    out, lse = flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, return_lse=True, **kw)
    dq, delta = flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, qpos, valid, **kw)
    ref = flash_attention_bwd_plain(q, k, v, qpos, valid, out, lse, do, **kw)
    torch.cuda.synchronize()
    u = GRAD_ULP[q.dtype]
    names = ("dq", "dk", "dv")
    errs = {n: max_err(a, r) for n, a, r in zip(names, (dq, dk, dv), ref)}
    ratios = {n: grad_ratio(a, r, u) for n, a, r in zip(names, (dq, dk, dv), ref)}
    ratios["dv_tensors"] = (dv, ref[2])
    return errs, ratios


def check_planted_faults(dv: torch.Tensor, dv_ref: torch.Tensor, u: float) -> None:
    """The element-wise check must refuse a dV that is wrong past slot 512,
    where causal dV is small: zeroed there, or 3% too large there. Prints
    each fault's reading beside the one that a single tolerance of 2e-2 times
    the plain dV's largest magnitude gives (a fault passes it below 1)."""
    for fault, fn in (("zeroed past slot 512", lambda x: x.zero_()),
                      ("x1.03 past slot 512", lambda x: x.mul_(1.03))):
        bad = dv.clone()
        fn(bad[:, 512:])
        ratio = grad_ratio(bad, dv_ref, u)
        whole = max_err(bad, dv_ref) / (2e-2 * float(dv_ref.float().abs().max()))
        print(f"[flash_bwd] planted fault, dV {fault}: worst ratio {ratio:.3f} (must exceed 1); "
              f"max_abs_err / (2e-2 |plain|max) {whole:.3f}")
        if ratio <= 1.0:
            raise AssertionError(f"the backward check does not see a dV {fault}")


def _train_lengths(seed: int) -> list:
    rng = np.random.default_rng(seed + 3)
    return [int(rng.integers(TRAIN_MIN_LEN, TRAIN_SEQ + 1)) for _ in range(TRAIN_ROWS)]


def check_flash_bwd(gen, seed: int) -> tuple:
    """K5 (dQ) and K4 (dK/dV) at the training shapes: 4 rows of 2048 slots
    right-padded to the lengths phase (e) trains on, 32 query heads over 8 kv
    heads, head_dim 128, bf16; causal, then with a 256-slot window, then with
    a softcap of 30. Timed in the causal case beside the plain versions and
    SDPA's backward (forward excluded; a yardstick the port never calls).
    The forward (K1) is held to its plain version on the same three cases
    and timed in the causal one beside its plain version and SDPA's forward.
    Returns the kernels' entries and K1's training-shape numbers."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_plain, flash_bwd_dkv,
                                                            flash_bwd_dkv_plain, flash_bwd_dq,
                                                            flash_bwd_dq_plain)

    lengths = _train_lengths(seed)
    u = GRAD_ULP[torch.bfloat16]
    for name, window, cap in (("causal", None, None), ("window_256", 256, None),
                              ("softcap_30", None, 30.0)):
        q, k, v, qpos, valid = _flash_inputs(gen, b=TRAIN_ROWS, sq=TRAIN_SEQ, skv=TRAIN_SEQ)
        for row, n in enumerate(lengths):
            valid[row, n:] = 0
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        kw = dict(scale=q.shape[-1] ** -0.5, is_causal=True, sliding_window=window,
                  logit_cap=cap)
        fwd_err, lse_err = _flash_errors(q, k, v, qpos, valid, **kw)
        print(f"[flash] training shape, {name}: max_abs_err out {fwd_err:.3e} (tol "
              f"{KERNEL_ATOL}) lse {lse_err:.3e} (tol {LSE_ATOL})")
        if fwd_err > KERNEL_ATOL or lse_err > LSE_ATOL:
            raise AssertionError(f"flash kernel disagrees with its plain version at the training "
                                 f"shape ({name})")
        errs, ratios = _bwd_errors(q, k, v, qpos, valid, do, **kw)
        dv, dv_ref = ratios.pop("dv_tensors")
        print(f"[flash_bwd] {name} lengths {lengths}: " + ", ".join(
            f"{n} max_abs_err {errs[n]:.3e}, worst |err| / (2^-7 |plain| + 2^-8 rms) "
            f"{ratios[n]:.3f}" for n in errs) + " (tol 1)")
        if any(r > 1.0 for r in ratios.values()):
            raise AssertionError(f"flash backward kernels disagree with their plain version ({name})")
        if name != "causal":
            continue
        check_planted_faults(dv, dv_ref, u)
        del dv, dv_ref
        b, s, h, d = q.shape
        out, lse = flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, return_lse=True,
                                   **kw)
        dq, delta = flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw)
        dq_ms = event_ms(lambda: flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw))
        dkv_ms = event_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, qpos, valid, **kw))
        dq_plain_ms = event_ms(lambda: flash_bwd_dq_plain(q, k, v, out, do, lse, qpos, valid,
                                                          **kw), iters=2)
        dkv_plain_ms = event_ms(lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, qpos,
                                                            valid, **kw), iters=2)
        slots = torch.arange(s, device="cuda")
        mask = (valid != 0)[:, None, :] & (slots[None, None, :] <= qpos[:, :, None])
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
        out_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],
                                               scale=kw["scale"], enable_gqa=True)
        do_t = do.transpose(1, 2)
        library_ms = event_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                          retain_graph=True), iters=3)
        del out_t
        visible = int(mask.sum())
        # K1 at the training shape: its operations bound, plain version, SDPA's forward
        fwd_ms = event_ms(lambda: flash_attention(q, k, v, q_positions=qpos, kv_valid=valid,
                                                  **kw), iters=10)
        fwd_plain_ms = event_ms(lambda: flash_attention_plain(q, k, v, qpos, valid, **kw),
                                iters=2)
        qd, kd, vd = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        fwd_library_ms = event_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask[:, None], scale=kw["scale"], enable_gqa=True), iters=10)
        fwd_bound, fwd_by = bound_ms(
            (2 * q.numel() + k.numel() + v.numel()) * 2 + b * h * s * 4
            + (qpos.numel() + valid.numel()) * 4,  # q, k, v, out; lse; mask data
            4.0 * d * h * visible)
        k1_train = dict(ms_train=fwd_ms, plain_ms_train=fwd_plain_ms, bound_ms_train=fwd_bound,
                        bound_by_train=fwd_by, library_ms_train=fwd_library_ms,
                        max_abs_err_train=fwd_err,
                        shape_train=f"B={b} S={s} H={h} KVH={k.shape[2]} D={d} bf16 causal, "
                                    f"right-padded to {lengths}")
        print(f"[flash] training shape B={b} S={s} H={h} KVH={k.shape[2]} D={d}, {visible} "
              f"visible (row, slot) pairs: K1 {fwd_ms:.4f} ms, plain {fwd_plain_ms:.4f} ms, "
              f"sdpa forward {fwd_library_ms:.4f} ms, bound {fwd_bound:.4f} ms ({fwd_by})")
        q_bytes, kv_bytes = q.numel() * 2, (k.numel() + v.numel()) * 2  # bf16
        fixed = 2 * b * h * s * 4 + (qpos.numel() + valid.numel()) * 4  # lse, delta; mask data
        # K5 reads Q, O, dO, K, V, lse and writes dQ, delta; 3 products
        dq_bound, dq_by = bound_ms(4 * q_bytes + kv_bytes + fixed, 6.0 * d * h * visible)
        # K4 reads Q, dO, K, V, lse, delta and writes dK, dV; 4 products
        dkv_bound, dkv_by = bound_ms(2 * q_bytes + 2 * kv_bytes + fixed, 8.0 * d * h * visible)
        common = dict(route="cuda", source="transformers_tpu_torch/csrc/flash_bwd.cu",
                      library_ms=library_ms,
                      library="SDPA backward (autograd.grad of one SDPA call, boolean mask, "
                              "enable_gqa)")
        results = [
            dict(name="flash_bwd_dkv",
                 replaces="transformers_tpu/ops/pallas/flash_attention.py:445",
                 max_abs_err=max(errs["dk"], errs["dv"]), ms=dkv_ms, plain_ms=dkv_plain_ms,
                 bound_ms=dkv_bound, bound_by=dkv_by, **common),
            dict(name="flash_bwd_dq",
                 replaces="transformers_tpu/ops/pallas/flash_attention.py:471",
                 max_abs_err=errs["dq"], ms=dq_ms, plain_ms=dq_plain_ms, bound_ms=dq_bound,
                 bound_by=dq_by, **common)]
        print(f"[flash_bwd] B={b} S={s} H={h} KVH={k.shape[2]} D={d}, {visible} visible "
              f"(row, slot) pairs: K4 dK/dV {dkv_ms:.4f} ms (plain {dkv_plain_ms:.4f}, bound "
              f"{dkv_bound:.4f} {dkv_by}), K5 dQ {dq_ms:.4f} ms (plain {dq_plain_ms:.4f}, bound "
              f"{dq_bound:.4f} {dq_by}), SDPA backward {library_ms:.4f} ms")
    return results, k1_train


def _decode_inputs(gen, *, b=8, h=32, kvh=8, d=128, s=160, starts=None, holes=0,
                   dtype=torch.bfloat16):
    dev = "cuda"
    bf = dtype
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(bf)
    k_new = torch.randn((b, 1, kvh, d), generator=gen, device=dev).to(bf)
    v_new = torch.randn((b, 1, kvh, d), generator=gen, device=dev).to(bf)
    ang = torch.randn((b, 1, d), generator=gen, device=dev)
    cos, sin = ang.cos().to(bf), ang.sin().to(bf)
    kc = torch.randn((b, kvh, s, d), generator=gen, device=dev).to(bf)
    vc = torch.randn((b, kvh, s, d), generator=gen, device=dev).to(bf)
    start = torch.tensor(starts or [0] * b, dtype=torch.int32, device=dev)
    valid = (torch.arange(s, device=dev)[None, :] >= start[:, None].long()).to(torch.int32)
    if holes:
        drop = torch.rand((b, s), generator=gen, device=dev) < holes
        valid = valid.masked_fill(drop, 0)
    return q, k_new, v_new, cos, sin, kc, vc, start, valid


def _decode_case(gen, c: dict) -> tuple:
    """K2's inputs for one case of ``check_decode``: ``c`` gives s, pos and
    optionally starts, holes and a dead span of slots [lo, hi) of every row."""
    args = _decode_inputs(gen, s=c["s"], starts=c.get("starts"), holes=c.get("holes", 0))
    if "dead" in c:
        args[-1][:, c["dead"][0]:c["dead"][1]] = 0
    return args


def _decode_run(fn, args, pos, scale):
    """``fn`` (the wrapper or a plain version) on fresh copies of the caches:
    the output and the caches it wrote."""
    q, kn, vn, cos, sin, kc, vc, start, valid = args
    kc, vc = kc.clone(), vc.clone()
    out = fn(q, kn, vn, cos, sin, kc, vc, pos, start, valid, scale=scale)
    return out, kc, vc


def check_decode_graph_pos(gen) -> None:
    """K2 reads pos from the card: one call captured in a CUDA graph with pos
    a device tensor, the tensor set to two other slots, the graph replayed;
    output and caches must equal, bit for bit, eager calls at those slots."""
    from transformers_tpu_torch.ops.fused_decode import fused_decode_attention

    args = _decode_inputs(gen, s=PROMPT + NEW, starts=list(PADS))
    q, kn, vn, cos, sin, kc, vc, start, valid = args
    scale = q.shape[-1] ** -0.5
    pos_t = torch.full((1,), PROMPT + NEW - 1, dtype=torch.int32, device="cuda")
    kc_g, vc_g = kc.clone(), vc.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # first call outside capture
        fused_decode_attention(q, kn, vn, cos, sin, kc_g, vc_g, pos_t, start, valid, scale=scale)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = fused_decode_attention(q, kn, vn, cos, sin, kc_g, vc_g, pos_t, start, valid,
                                       scale=scale)
    for p in (PROMPT + 7, PROMPT - 30):
        pos_t.fill_(p)
        kc_g.copy_(kc)
        vc_g.copy_(vc)
        graph.replay()
        want, kc_e, vc_e = _decode_run(fused_decode_attention, args,
                                       torch.full((1,), p, dtype=torch.int32, device="cuda"), scale)
        torch.cuda.synchronize()
        same = (torch.equal(out_g, want), torch.equal(kc_g, kc_e), torch.equal(vc_g, vc_e))
        written = not torch.equal(kc_g[:, :, p], kc[:, :, p])
        print(f"[decode] graph replay at pos {p} (captured at {PROMPT + NEW - 1}): output, "
              f"k cache, v cache bitwise equal to an eager call {same}; slot {p} written "
              f"{written}")
        if not all(same) or not written:
            raise AssertionError("fused decode: a graph replay does not follow pos on the card")


def check_decode(gen, seed: int) -> dict:
    """K2 against its plain version: the generate shape (8 rows, 32 query heads
    over 8 kv heads, head_dim 128, bf16, S = 160, the smoke's left pads), a
    first token, kv_valid holes, a dead span of 70 slots, a row whose start
    lies at or past pos, a dead span over a whole split (S = 2048, pos =
    2000) and a long context (S = 4096, pos = 4000); the last two are held
    also relative to the outputs' scale, since a dropped split can pass
    KERNEL_ATOL. At the generate shape and the two long cases the kernel runs
    twice (bitwise-equal outputs required) and is held to
    ``fused_decode_split_plain``. Timed at the generate shape with pos a
    device tensor, as the main path passes it, and at S = 4096 and S = 320
    with pos = 300, which shows what the idle splits cost; then the
    graph-replay check of pos on the card. The dead spans, the starts past
    pos and the idle-split timing draw from their own generator, so that the
    other checks' inputs stay as they were before those cases existed."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.fused_decode import (SPLIT_SLOTS, fused_decode_attention,
                                                         fused_decode_plain,
                                                         fused_decode_split_plain)

    cases = {
        "first_token": dict(s=160, pos=0),
        "left_padded": dict(s=PROMPT + NEW, pos=PROMPT + NEW - 1, starts=list(PADS)),
        "mask_holes": dict(s=160, pos=100, holes=0.2),
        "dead_span": dict(s=160, pos=150, dead=(20, 90)),
        "start_past_pos": dict(s=160, pos=60, starts=[0, 61, 100, 0, 3, 60, 159, 7]),
        "dead_split": dict(s=2048, pos=2000, dead=(512, 1100)),  # a whole split of holes
        "long_context": dict(s=4096, pos=4000, starts=[0, 100, 511, 512, 0, 7, 1000, 3]),
    }
    long_cases = ("dead_split", "long_context")  # held relative to the outputs' scale too
    extra_gen = torch.Generator(device="cuda").manual_seed(seed + 9)
    result = None
    for name, c in cases.items():
        new_case = name in ("dead_span", "start_past_pos", "dead_split")
        args = _decode_case(extra_gen if new_case else gen, c)
        q, kn, vn, cos, sin, kc, vc, start, valid = args
        pos = c["pos"]
        scale = q.shape[-1] ** -0.5
        out, kc_k, vc_k = _decode_run(fused_decode_attention, args, pos, scale)
        ref, kc_p, vc_p = _decode_run(fused_decode_plain, args, pos, scale)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        cache_err = max(max_err(kc_k, kc_p), max_err(vc_k, vc_p))
        ratio = grad_ratio(out, ref, GRAD_ULP[q.dtype])
        print(f"[decode] {name}: max_abs_err out {err:.3e}, caches {cache_err:.3e} "
              f"(tol {KERNEL_ATOL})" + (f", grad_ratio {ratio:.4f} at u = 2^-7 (at most 1)"
                                         if name in long_cases else ""))
        if err > KERNEL_ATOL or cache_err > KERNEL_ATOL or (name in long_cases
                                                             and ratio > 1.0):
            raise AssertionError(f"fused decode kernel disagrees with its plain version ({name})")
        if name in ("left_padded", *long_cases):
            again = _decode_run(fused_decode_attention, args, pos, scale)[0]
            split_ref = _decode_run(functools.partial(fused_decode_split_plain,
                                                      split_slots=SPLIT_SLOTS), args, pos, scale)[0]
            torch.cuda.synchronize()
            split_err = max_err(out, split_ref)
            print(f"[decode] {name}: two runs bitwise equal {torch.equal(out, again)}; against "
                  f"the split plain version ({SPLIT_SLOTS} slots a split) max_abs_err "
                  f"{split_err:.3e} (tol {KERNEL_ATOL})")
            if not torch.equal(out, again):
                raise AssertionError(f"fused decode kernel: two runs differ ({name})")
            if split_err > KERNEL_ATOL:
                raise AssertionError("fused decode kernel disagrees with the split plain version")
        if name != "left_padded":
            continue
        b, _, h, d = q.shape
        kvh, s = kc.shape[1], kc.shape[2]
        pos_t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
        ms = device_ms(lambda: fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos_t, start,
                                                      valid, scale=scale))
        kc2, vc2 = kc.clone(), vc.clone()
        plain_ms = device_ms(lambda: fused_decode_plain(q, kn, vn, cos, sin, kc2, vc2, pos,
                                                        start, valid, scale=scale))
        slots = torch.arange(s, device="cuda")[None, :]
        live = ((slots >= start[:, None].long()) & (slots < pos) & (valid != 0)) | (slots == pos)
        qt = q.transpose(1, 2)
        m4 = live[:, None, None, :]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=m4, scale=scale, enable_gqa=True))
        n_live = int(live.sum()) - b  # cache slots read; the new column comes in registers
        nbytes = (n_live * kvh * d * 2 * 2                      # K and V of live slots
                  + (q.numel() + kn.numel() + vn.numel() + cos.numel() + sin.numel()
                     + out.numel()) * 2
                  + 2 * b * kvh * d * 2                         # cache write at slot pos
                  + valid.numel() * 4 + start.numel() * 4)
        bms, by = bound_ms(nbytes, 4.0 * d * h * (n_live + b))
        # the grid is sized from S: what idle splits cost, at pos 300 of 4096 and of 320 slots
        idle = {}
        for s_idle in (4096, 320):
            a = _decode_inputs(extra_gen, s=s_idle)
            p300 = torch.full((1,), 300, dtype=torch.int32, device="cuda")
            idle[s_idle] = device_ms(lambda: fused_decode_attention(*a[:7], p300, *a[7:],
                                                                    scale=scale))
        result = dict(name="fused_decode", route="cuda",
                      source="transformers_tpu_torch/csrc/fused_decode.cu",
                      replaces="transformers_tpu/ops/pallas/fused_decode.py:326",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=library_ms, split_slots=SPLIT_SLOTS,
                      ms_pos300_s4096=idle[4096], ms_pos300_s320=idle[320])
        print(f"[decode] B={b} S={s} H={h} KVH={kvh} D={d} pos={pos}: {ms:.4f} ms (split "
              f"{SPLIT_SLOTS} slots, pos on the card), plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by}); at pos 300: {idle[4096]:.4f} ms "
              f"with S = 4096, {idle[320]:.4f} ms with S = 320")
    check_decode_graph_pos(extra_gen)
    return result


def _static_inputs(gen, *, b, s, h, kvh, d, starts, ends, dtype=torch.bfloat16):
    dev = "cuda"
    q = torch.randn((b, 1, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dtype)
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    en = torch.tensor(ends, dtype=torch.int32, device=dev)
    return q, k, v, st, en


def _static_error(q, k, v, st, en, window) -> tuple:
    """K7 against its plain version: the max abs error, the worst
    ``grad_ratio`` at q's GRAD_ULP, and the kernel's output."""
    from transformers_tpu_torch.ops.decode_attention import (decode_attention,
                                                             decode_attention_plain)

    kw = dict(scale=q.shape[-1] ** -0.5, sliding_window=window)
    out = decode_attention(q, k, v, st, en, **kw)
    ref = decode_attention_plain(q, k, v, st, en, **kw)
    torch.cuda.synchronize()
    if out[en <= st].any():
        raise AssertionError("static decode: a row with no live slot is not zero")
    return max_err(out, ref), grad_ratio(out, ref, GRAD_ULP[q.dtype]), out


def check_static_decode(gen, seed: int) -> dict:
    """K7 at Llama-3-8B decode geometry: 8 rows, 32 query heads over 8 kv
    heads, head_dim 128, bf16, a BSHD cache of 224 slots with ragged live
    ranges [start, end) (starts 0-39, ends 150-224), without and with a
    128-slot window; then a cache of 4096 slots with live ranges of 2000-4000
    slots, held also relative to the outputs' scale (a dropped split can pass
    KERNEL_ATOL). In the ragged case and the long one the kernel runs twice
    (bitwise-equal outputs required) and is held to ``decode_split_plain``.
    Timed in the ragged case beside SDPA with a boolean mask over the same
    cache, transposed to BHSD beforehand (a yardstick the port never calls).
    The JAX package runs this kernel from no model path: its launches are
    those of this phase's checks."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.decode_attention import (SPLIT_SLOTS, decode_attention,
                                                             decode_attention_plain,
                                                             decode_split_plain)

    b, s, h, kvh, d = BATCH, 224, 32, 8, 128
    starts = torch.randint(0, 40, (b,), generator=gen, device="cuda").tolist()
    ends = torch.randint(150, s + 1, (b,), generator=gen, device="cuda").tolist()
    # the long case draws from its own generator: the other checks' inputs stay as they were
    long_gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    long_starts = torch.randint(0, 100, (b,), generator=long_gen, device="cuda").tolist()
    long_ends = [st + n for st, n in zip(long_starts, torch.randint(
        2000, 3997, (b,), generator=long_gen, device="cuda").tolist())]
    result = None
    for name, window in (("ragged", None), ("ragged_window_128", 128), ("long_context", None)):
        if name == "long_context":
            q, k, v, st, en = _static_inputs(long_gen, b=b, s=4096, h=h, kvh=kvh, d=d,
                                             starts=long_starts, ends=long_ends)
        else:
            q, k, v, st, en = _static_inputs(gen, b=b, s=s, h=h, kvh=kvh, d=d, starts=starts,
                                             ends=ends)
        err, ratio, out = _static_error(q, k, v, st, en, window)
        spans = list(zip(*((long_starts, long_ends) if name == "long_context"
                           else (starts, ends))))
        print(f"[static decode] {name} [start, end) {spans}: max_abs_err {err:.3e} (tol "
              f"{KERNEL_ATOL})" + (f", grad_ratio {ratio:.4f} at u = 2^-7 (at most 1)"
                                   if name == "long_context" else ""))
        if err > KERNEL_ATOL or (name == "long_context" and ratio > 1.0):
            raise AssertionError(f"static decode kernel disagrees with its plain version ({name})")
        if window is not None:
            continue
        scale = d ** -0.5
        again = decode_attention(q, k, v, st, en, scale=scale)
        split_ref = decode_split_plain(q, k, v, st, en, scale=scale, split_slots=SPLIT_SLOTS)
        torch.cuda.synchronize()
        split_err = max_err(out, split_ref)
        print(f"[static decode] {name}: two runs bitwise equal {torch.equal(out, again)}; "
              f"against the split plain version ({SPLIT_SLOTS} slots a split) max_abs_err "
              f"{split_err:.3e} (tol {KERNEL_ATOL})")
        if not torch.equal(out, again):
            raise AssertionError(f"static decode kernel: two runs differ ({name})")
        if split_err > KERNEL_ATOL:
            raise AssertionError("static decode kernel disagrees with the split plain version")
        if name != "ragged":
            continue
        checked = decode_attention.launches
        ms = device_ms(lambda: decode_attention(q, k, v, st, en, scale=scale))
        plain_ms = device_ms(lambda: decode_attention_plain(q, k, v, st, en, scale=scale))
        decode_attention.launches = checked  # timing launches are not checks
        slots = torch.arange(s, device="cuda")[None, :]
        live = (slots >= st[:, None].long()) & (slots < en[:, None].long())
        qt = q.transpose(1, 2)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        m4 = live[:, None, None, :]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=m4, scale=scale, enable_gqa=True))
        n_live = int(live.sum())
        nbytes = (n_live * kvh * d * 2 * 2  # K and V of live slots
                  + 2 * q.numel() * 2       # q and out
                  + 2 * b * 4)              # starts, ends
        bms, by = bound_ms(nbytes, 4.0 * d * h * n_live)
        result = dict(name="static_decode", route="cuda",
                      source="transformers_tpu_torch/csrc/fused_decode.cu",
                      replaces="transformers_tpu/ops/pallas/decode_attention.py:168",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=library_ms, split_slots=SPLIT_SLOTS,
                      library="SDPA with a boolean mask over the cache, transposed to BHSD "
                              "beforehand")
        print(f"[static decode] B={b} S={s} H={h} KVH={kvh} D={d} live slots {n_live}: "
              f"{ms:.4f} ms (split {SPLIT_SLOTS} slots), plain {plain_ms:.4f} ms, sdpa "
              f"{library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return result


def _paged_inputs(gen, *, n=8, h=32, kvh=8, d=128, bs=32, ctx_lens, dtype=torch.bfloat16):
    """Random pools with shuffled page ids: row i holds ceil(ctx_i / bs) pages;
    page 0 is the null page and dead table entries point at it."""
    dev = "cuda"
    maxb = max(1, max(-(-c // bs) for c in ctx_lens))
    pages = sum(-(-c // bs) for c in ctx_lens) + 1
    q = torch.randn((n, 1, h, d), generator=gen, device=dev).to(dtype)
    k_pool = torch.randn((pages, kvh, bs, d), generator=gen, device=dev).to(dtype)
    v_pool = torch.randn((pages, kvh, bs, d), generator=gen, device=dev).to(dtype)
    perm = (torch.randperm(pages - 1, generator=gen, device=dev) + 1).tolist()
    tables = torch.zeros((n, maxb), dtype=torch.int32)
    for i, c in enumerate(ctx_lens):
        need = -(-c // bs)
        tables[i, :need] = torch.tensor(perm[:need], dtype=torch.int32)
        perm = perm[need:]
    ctx = torch.tensor(ctx_lens, dtype=torch.int32, device=dev)
    return q, k_pool, v_pool, tables.to(dev), ctx


def _paged_error(q, k_pool, v_pool, tables, ctx, window) -> tuple[float, float]:
    """The kernel against its plain version: the max abs error, and the worst
    ``grad_ratio`` at q's GRAD_ULP (a hold relative to the output's scale)."""
    from transformers_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                            paged_decode_plain)

    kw = dict(scale=q.shape[-1] ** -0.5, sliding_window=window)
    out = paged_decode_attention(q, k_pool, v_pool, tables, ctx, **kw)
    ref = paged_decode_plain(q, k_pool, v_pool, tables, ctx, **kw)
    torch.cuda.synchronize()
    return max_err(out, ref), grad_ratio(out, ref, GRAD_ULP[q.dtype])


def check_paged(gen, seed: int) -> list:
    """K6 at the CB path's shapes: 8 rows, 32 query heads over 8 kv heads,
    head_dim 128, pages of 32 slots, bf16, ragged contexts of 64-576 slots,
    without and with a 100-slot window; then contexts of 2000-4000 slots,
    which the kernel cuts into many splits. There the outputs are means of
    thousands of values, about as small as KERNEL_ATOL, so they are also held
    relative to their scale (``grad_ratio`` at most 1). At the CB shape the
    kernel runs twice (bitwise-equal outputs required), is held to the split
    version of the plain code too, and is timed, with its wrapper's host cost
    a call; its merge kernel is held to
    the plain merge on the plain partials and timed. Returns the entries of
    both kernels."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                            paged_decode_combine,
                                                            paged_decode_merge_plain,
                                                            paged_decode_partials_plain,
                                                            paged_decode_plain,
                                                            paged_decode_split_plain, split_size)

    ctx_lens = torch.randint(64, 577, (BATCH,), generator=gen, device="cuda").tolist()
    # the long contexts draw from their own generator: the other checks' inputs stay as they were
    long_gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    long_lens = torch.randint(2000, 4001, (BATCH,), generator=long_gen, device="cuda").tolist()
    results = []
    for name, lens, window in (("ragged", ctx_lens, None), ("ragged_window_100", ctx_lens, 100),
                               ("long_context", long_lens, None)):
        q, k_pool, v_pool, tables, ctx = _paged_inputs(
            long_gen if name == "long_context" else gen, ctx_lens=lens)
        err, ratio = _paged_error(q, k_pool, v_pool, tables, ctx, window)
        print(f"[paged] {name} ctx {lens}: max_abs_err {err:.3e} (tol {KERNEL_ATOL})"
              + (f", grad_ratio {ratio:.4f} at u = 2^-7 (at most 1)"
                 if name == "long_context" else ""))
        if err > KERNEL_ATOL or (name == "long_context" and ratio > 1.0):
            raise AssertionError(f"paged decode kernel disagrees with its plain version ({name})")
        if name != "ragged":
            continue
        n, _, h, d = q.shape
        kvh, bs = k_pool.shape[1], k_pool.shape[2]
        scale = d ** -0.5
        split = split_size(bs)
        out = paged_decode_attention(q, k_pool, v_pool, tables, ctx, scale=scale)
        again = paged_decode_attention(q, k_pool, v_pool, tables, ctx, scale=scale)
        split_plain = paged_decode_split_plain(q, k_pool, v_pool, tables, ctx, scale=scale,
                                               split_slots=split)
        torch.cuda.synchronize()
        split_err = max_err(out, split_plain)
        print(f"[paged] {name}: two runs bitwise equal {torch.equal(out, again)}; against the "
              f"split plain version ({split} slots a split) max_abs_err {split_err:.3e} (tol "
              f"{KERNEL_ATOL})")
        if not torch.equal(out, again):
            raise AssertionError("paged decode kernel: two runs on the same inputs differ")
        if split_err > KERNEL_ATOL:
            raise AssertionError("paged decode kernel disagrees with the split plain version")
        ms = device_ms(lambda: paged_decode_attention(q, k_pool, v_pool, tables, ctx,
                                                      scale=scale))
        # the CB decode loop is host-bound: K6's wrapper costs the host this much a layer
        wrapper_us = host_us(lambda: paged_decode_attention(q, k_pool, v_pool, tables, ctx,
                                                            scale=scale))
        plain_ms = device_ms(lambda: paged_decode_plain(q, k_pool, v_pool, tables, ctx,
                                                        scale=scale))
        # yardstick: SDPA over the same pages already gathered contiguous
        s = tables.shape[1] * bs
        kc = k_pool[tables.long()].permute(0, 2, 1, 3, 4).reshape(n, kvh, s, d).contiguous()
        vc = v_pool[tables.long()].permute(0, 2, 1, 3, 4).reshape(n, kvh, s, d).contiguous()
        live = torch.arange(s, device="cuda")[None, :] < ctx[:, None]
        qt, m4 = q.transpose(1, 2), live[:, None, None, :]
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(
            qt, kc, vc, attn_mask=m4, scale=scale, enable_gqa=True))
        n_live = sum(lens)
        nbytes = (n_live * kvh * d * 2 * 2                  # K and V of live slots
                  + 2 * q.numel() * 2                       # q and out
                  + tables.numel() * 4 + ctx.numel() * 4)
        bms, by = bound_ms(nbytes, 4.0 * d * h * n_live)
        results.append(dict(name="paged_decode", route="cuda",
                            source="transformers_tpu_torch/csrc/paged_decode.cu",
                            replaces="transformers_tpu/ops/pallas/paged_attention.py:216",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                            library_ms=library_ms, split_slots=split, host_us=wrapper_us,
                            library="SDPA over the pages gathered contiguous beforehand"))
        print(f"[paged] N={n} H={h} KVH={kvh} D={d} BS={bs} live slots {n_live}: {ms:.4f} ms "
              f"(split {split} slots, with the merge kernel), plain {plain_ms:.4f} ms, sdpa (pages "
              f"pre-gathered) {library_ms:.4f} ms, bound {bms:.4f} ms ({by}); the wrapper "
              f"costs the host {wrapper_us:.1f} us a call")

        # the merge kernel alone, on the plain partials of the same inputs
        ml, acc = paged_decode_partials_plain(q, k_pool, v_pool, tables, ctx, scale=scale,
                                              split_slots=split)
        max_slots = tables.shape[1] * bs
        merged = paged_decode_combine(ctx, ml, acc, torch.zeros_like(q), max_slots=max_slots,
                                      split_slots=split)
        ref = paged_decode_merge_plain(ml, acc, ctx, max_slots=max_slots,
                                       split_slots=split).to(q.dtype)
        torch.cuda.synchronize()
        n_split = torch.where(ctx > 0, (ctx.long() - 1) // split + 1, 0)
        multi = n_split > 1
        merge_err = max_err(merged[multi], ref[multi])
        if merge_err > KERNEL_ATOL or merged[~multi].any():
            raise AssertionError("paged decode merge kernel disagrees with the plain merge")
        merge_ms = device_ms(lambda: paged_decode_combine(ctx, ml, acc, merged,
                                                          max_slots=max_slots, split_slots=split))
        merge_plain_ms = device_ms(lambda: paged_decode_merge_plain(
            ml, acc, ctx, max_slots=max_slots, split_slots=split))
        read = int((n_split * multi).sum()) * h * (2 + d) * 4  # the live splits' partials
        mbms, mby = bound_ms(read + int(multi.sum()) * h * d * 2 + ctx.numel() * 4,
                             3.0 * int((n_split * multi).sum()) * h * d)
        results.append(dict(name="paged_decode_combine", route="cuda",
                            source="transformers_tpu_torch/csrc/paged_decode.cu",
                            replaces="transformers_tpu/ops/pallas/paged_attention.py:216",
                            max_abs_err=merge_err, ms=merge_ms, plain_ms=merge_plain_ms,
                            bound_ms=mbms, bound_by=mby, library_ms=None,
                            note="the merge of K6's split partials (the Pallas kernel "
                                 "carries one row's state across its sequential grid); no "
                                 "PyTorch call computes it"))
        print(f"[paged merge] {int(multi.sum())} of {n} rows over {split}-slot splits: "
              f"max_abs_err {merge_err:.3e} (tol {KERNEL_ATOL}), {merge_ms:.4f} ms, plain "
              f"{merge_plain_ms:.4f} ms, bound {mbms:.4f} ms ({mby})")
    return results


def check_reference_cases(gen) -> None:
    """Each kernel against its plain version on the reference's tests/ops
    cases, in float32, float16 and bf16: every build of the kernels (three
    storage types by head_dim 64, 128, 256, and for paged decode by query-head
    group of up to 4 and up to 8) runs at least once. The flash backward runs
    the forward's cases and those of the reference's backward tests, on the
    kernel forward's output and logsumexp."""
    from transformers_tpu_torch.ops.fused_decode import (fused_decode_attention,
                                                         fused_decode_plain)

    worst = {}
    for dtype, tol in TOLERANCE.items():
        for name, (b, sq, skv, h, kvh, d, pads, window, cap) in FLASH_OPS_CASES.items():
            q, k, v, qpos, valid = _flash_inputs(gen, b=b, sq=sq, skv=skv, h=h, kvh=kvh, d=d,
                                                 pads=pads, dtype=dtype)
            err, lse_err = _flash_errors(q, k, v, qpos, valid, scale=d ** -0.5,
                                         sliding_window=window, logit_cap=cap)
            if err > tol or lse_err > LSE_ATOL:
                raise AssertionError(f"flash kernel disagrees with its plain version: {name} "
                                     f"{dtype}: out {err:.3e} lse {lse_err:.3e}")
            worst[("flash_fwd", dtype)] = max(worst.get(("flash_fwd", dtype), 0.0), err)
        for name, (b, sq, skv, h, kvh, d, pads, window, cap) in {**FLASH_OPS_CASES,
                                                                **FLASH_BWD_CASES}.items():
            q, k, v, qpos, valid = _flash_inputs(gen, b=b, sq=sq, skv=skv, h=h, kvh=kvh, d=d,
                                                 pads=pads, dtype=dtype)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            errs, ratios = _bwd_errors(q, k, v, qpos, valid, do, scale=d ** -0.5,
                                       sliding_window=window, logit_cap=cap)
            del ratios["dv_tensors"]
            if any(r > 1.0 for r in ratios.values()):
                raise AssertionError(f"flash backward kernels disagree with their plain version: "
                                     f"{name} {dtype}: max_abs_err {errs}, ratios {ratios}")
            for kernel, grads in (("flash_bwd_dq", ("dq",)), ("flash_bwd_dkv", ("dk", "dv"))):
                worst[(kernel, dtype)] = max(worst.get((kernel, dtype), 0.0),
                                             *(ratios[n] for n in grads))
        for name, (b, h, kvh, d, s, pos, starts, holes) in DECODE_OPS_CASES.items():
            q, kn, vn, cos, sin, kc, vc, start, valid = _decode_inputs(
                gen, b=b, h=h, kvh=kvh, d=d, s=s, starts=starts, holes=holes, dtype=dtype)
            kc2, vc2 = kc.clone(), vc.clone()
            out = fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos, start, valid,
                                         scale=d ** -0.5)
            ref = fused_decode_plain(q, kn, vn, cos, sin, kc2, vc2, pos, start, valid,
                                     scale=d ** -0.5)
            torch.cuda.synchronize()
            err = max(max_err(out, ref), max_err(kc, kc2), max_err(vc, vc2))
            if err > tol:
                raise AssertionError(f"fused decode kernel disagrees with its plain version: "
                                     f"{name} {dtype}: {err:.3e}")
            worst[("fused_decode", dtype)] = max(worst.get(("fused_decode", dtype), 0.0), err)
        for name, (n, h, kvh, d, bs, ctx_lens, window) in PAGED_OPS_CASES.items():
            q, k_pool, v_pool, tables, ctx = _paged_inputs(gen, n=n, h=h, kvh=kvh, d=d, bs=bs,
                                                           ctx_lens=ctx_lens, dtype=dtype)
            err = _paged_error(q, k_pool, v_pool, tables, ctx, window)[0]
            if err > tol:
                raise AssertionError(f"paged decode kernel disagrees with its plain version: "
                                     f"{name} {dtype}: {err:.3e}")
            worst[("paged_decode", dtype)] = max(worst.get(("paged_decode", dtype), 0.0), err)
        for name, (b, s, h, kvh, d, starts, ends, window) in STATIC_DECODE_OPS_CASES.items():
            err = _static_error(*_static_inputs(gen, b=b, s=s, h=h, kvh=kvh, d=d, starts=starts,
                                                ends=ends, dtype=dtype), window)[0]
            if err > tol:
                raise AssertionError(f"static decode kernel disagrees with its plain version: "
                                     f"{name} {dtype}: {err:.3e}")
            worst[("static_decode", dtype)] = max(worst.get(("static_decode", dtype), 0.0), err)
    n_bwd = len(FLASH_OPS_CASES) + len(FLASH_BWD_CASES)
    n_cases = {"flash_fwd": len(FLASH_OPS_CASES), "fused_decode": len(DECODE_OPS_CASES),
               "paged_decode": len(PAGED_OPS_CASES), "flash_bwd_dq": n_bwd,
               "static_decode": len(STATIC_DECODE_OPS_CASES),
               "flash_bwd_dkv": n_bwd}
    for (kernel, dtype), err in worst.items():
        if kernel.startswith("flash_bwd"):
            what, tol = f"worst |err| / (u |plain| + u/2 rms), u = {GRAD_ULP[dtype]:.3g},", 1
        else:
            what, tol = "max_abs_err", TOLERANCE[dtype]
        print(f"[ops cases] {kernel} {str(dtype).replace('torch.', '')}: {what} "
              f"{err:.3e} over {n_cases[kernel]} cases (tol {tol})")


# Q1 / Q2: the seven projections of a Llama-3-8B layer come in four shapes (N x K)
QUANT_SHAPES = ((4096, 4096), (1024, 4096), (14336, 4096), (4096, 14336))
QUANT_ROWS = (1, 3, 8, 16)  # decode rows: batch 1, ragged 3, 8 and 16
QUANT_PREFILL_ROWS = 256  # Q2's route at a prefill's rows (a CB chunk is at most 128)
QUANT_SWEEP_ROWS = (1, 2, 4, 8, 16, 32, 64)
# the shape and rows of the kernels line's numbers: gate/up at the batch-16 decode step
QUANT_MAIN_SHAPE, QUANT_MAIN_ROWS = (14336, 4096), 16
L2_BYTES = 50 * 1024 ** 2


# Q1 / Q2 outputs (x ~ N(0, 1), weights ~ N(0, 1/K)) have a standard deviation
# of ~1 and reach ~5. Both sides sum in f32 and round once, so they may differ
# by one rounding step of the activation type: each output is held to
# grad_ratio at most 1 (u = GRAD_ULP, one step of its own size), and the
# absolute TOLERANCE holds where it is set for, below QUANT_ATOL_RANGE (one
# step of bf16 at 2-4 is 2^-6 < 2e-2; at 4-8 it is 2^-5, above it).
QUANT_ATOL_RANGE = 4.0


def _quantized_weights(gen, n, k, method):
    """Codes and scale of an [n, k] weight of N(0, 1/k) entries."""
    from transformers_tpu_torch.quantizers import get_quantizer
    from transformers_tpu_torch.quantizers.weight_only import (Fp8WeightOnlyConfig,
                                                               Int4WeightOnlyConfig,
                                                               Int8WeightOnlyConfig)

    cfg = {"int8": Int8WeightOnlyConfig, "int4": Int4WeightOnlyConfig,
           "fp8": Fp8WeightOnlyConfig}[method]()
    w = torch.randn((n, k), generator=gen, device="cuda") * k ** -0.5
    return get_quantizer(cfg).quantize_tensor("w", w)


def _cold(make, nbytes: int) -> list:
    """Enough copies of a weight (``make(i)``) that cycling through them moves
    more than the L2 cache holds, so each call reads its weight from device
    memory as a decode step's 224 different weights do."""
    return [make(i) for i in range(max(1, -(-2 * L2_BYTES // nbytes)))]


def _cycled(fn, items):
    """``fn(item)`` over ``items`` in turn, one per call (captured in order)."""
    it = [0]

    def call():
        fn(items[it[0] % len(items)])
        it[0] += 1
    return call


def check_wide_buffer_replay(gen) -> None:
    """A graph of Q2's route (above ROW_THRESHOLD rows, as a decode step of a
    large batch captures it), replayed after a later call grew Q2's buffer:
    its output equals the eager call's, and memory allocated since the growth
    keeps its contents. That memory is blocks of the outgrown buffer's size,
    taken until the allocator has to reserve more: a freed buffer would be
    among them, or cut into them."""
    from transformers_tpu_torch.ops import cuda_build
    from transformers_tpu_torch.ops import quantized_linear as ql

    torch.cuda.empty_cache()
    n, k = 1024, 4096
    codes, scale = _quantized_weights(gen, n, k, "int8")
    x = torch.randn((2 * ql.ROW_THRESHOLD, k), generator=gen, device="cuda").to(torch.bfloat16)
    # sized first on this stream: the allocator hands a stream's freed blocks
    # to that stream, and the fillers below come from this one
    ql.quantized_linear(x, codes, scale, in_features=k)
    graph = cuda_build.CountedGraph()
    eager, y = graph.capture_after_run(lambda: ql.quantized_linear(x, codes, scale,
                                                                   in_features=k))
    old = ql._WIDE[(x.device, torch.bfloat16)]
    old_numel, rows = old.numel(), old.numel() // k + 8
    big, big_scale = _quantized_weights(gen, rows, k, "int8")
    ql.quantized_linear(x, big, big_scale, in_features=k)  # grows the buffer
    if ql._WIDE[(x.device, torch.bfloat16)].numel() <= old_numel:
        raise AssertionError("Q2's buffer did not grow")
    del big, big_scale, old
    fillers = []
    while len(fillers) < 256:
        reserved = torch.cuda.memory_reserved()
        fillers.append(torch.full((old_numel,), 7.0, dtype=torch.bfloat16, device="cuda"))
        if torch.cuda.memory_reserved() > reserved:
            break
    y.zero_()
    graph.replay()
    torch.cuda.synchronize()
    kept = all(bool((f == 7.0).all()) for f in fillers)
    same = torch.equal(y, eager)
    print(f"[quantized] Q2 graph replayed after its buffer grew: output == eager {same}, "
          f"{len(fillers)} blocks allocated since untouched {kept}")
    if not (same and kept):
        raise AssertionError("a graph of Q2's route replays into a buffer it no longer owns")


def check_quantized_linear(gen) -> list:
    """Q1 (quantized_matmul) and Q2 (widen_codes, then torch.mm) against the
    plain ``quantized_dot`` for each code type (int8, int4, fp8) and
    activation type (bf16, f16, f32) at the four Llama-3-8B projection shapes
    and 1, 3, 8 and 16 rows (Q2 also at a prefill's 256), plus int4 at K =
    4104 (8 values past the last whole 512-value tile, not a multiple of a
    16-byte vector of 32 values); held element by element to one rounding
    step (``grad_ratio``) and to TOLERANCE below QUANT_ATOL_RANGE, since both
    sides sum in f32 and round once. Then a graph of Q2's route replayed
    after Q2's buffer grew, the times at the main shape, and the rows sweep
    that set ROW_THRESHOLD."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops import quantized_linear as ql
    from transformers_tpu_torch.quantizers.weight_only import (dequantize_int8, quantized_dot,
                                                               unpack_int4_codes)

    def plain(x, codes, scale, k):
        w = unpack_int4_codes(codes) if ql.code_type(codes, k) == "int4" else codes
        return quantized_dot(x, w, scale, x.dtype)

    worst = {}
    cases = [(n, k, m) for n, k in QUANT_SHAPES for m in QUANT_ROWS]
    for method in ("int8", "int4", "fp8"):
        extra = [(512, 4104, 3), (512, 4104, 16)] if method == "int4" else []
        weights = {}
        for n, k, m in cases + extra:
            if (n, k) not in weights:
                weights[(n, k)] = _quantized_weights(gen, n, k, method)
            codes, scale = weights[(n, k)]
            for dtype in (torch.bfloat16, torch.float16, torch.float32):
                for rows, route in ((m, "q1"), (m, "q2"), (QUANT_PREFILL_ROWS, "q2")):
                    if rows == QUANT_PREFILL_ROWS and m != QUANT_ROWS[-1]:
                        continue
                    x = torch.randn((rows, k), generator=gen, device="cuda").to(dtype)
                    ref = plain(x, codes, scale, k)
                    out = (ql.quantized_matmul(x, codes, scale, k) if route == "q1"
                           else ql._widened_matmul(x, codes, scale, k))
                    torch.cuda.synchronize()
                    in_range = ref.float().abs() < QUANT_ATOL_RANGE
                    err = float((out.float() - ref.float()).abs()[in_range].max())
                    ratio = grad_ratio(out, ref, GRAD_ULP[dtype])
                    key = (route, method, str(dtype).replace("torch.", ""))
                    w_err, w_ratio, w_ref = worst.get(key, (0.0, 0.0, 0.0))
                    worst[key] = (max(w_err, err), max(w_ratio, ratio),
                                  max(w_ref, float(ref.float().abs().max())))
                    if not (err <= TOLERANCE[dtype] and ratio <= 1.0
                            and bool(torch.isfinite(out).all())):
                        raise AssertionError(f"{route} {method} {dtype} N={n} K={k} M={rows}: "
                                             f"max_abs_err {err:.3e} (tol {TOLERANCE[dtype]}) "
                                             f"below |{QUANT_ATOL_RANGE}|, grad_ratio "
                                             f"{ratio:.3f} (at most 1)")
        del weights
    for (route, method, dtype), (err, ratio, top) in sorted(worst.items()):
        print(f"[quantized] {route} {method} x {dtype}: max_abs_err {err:.3e} where |plain| < "
              f"{QUANT_ATOL_RANGE} (tol {TOLERANCE[getattr(torch, dtype)]}), worst |err| / "
              f"(u |plain| + u/2 rms) {ratio:.3f} at u = {GRAD_ULP[getattr(torch, dtype)]:.3g} "
              f"(at most 1), largest |plain| {top:.2f}, over N x K in {QUANT_SHAPES}, M in "
              f"{QUANT_ROWS} (q2 also {QUANT_PREFILL_ROWS})"
              + (", int4 K=4104" if method == "int4" else ""))
    check_wide_buffer_replay(gen)

    # times, each weight read from device memory (copies cycled past the L2)
    by_shape = {}
    for n, k in QUANT_SHAPES:
        codes_list = _cold(lambda i: _quantized_weights(gen, n, k, "int8"), n * k)
        dense = _cold(lambda i: (torch.randn((n, k), generator=gen, device="cuda")
                                       * k ** -0.5).to(torch.bfloat16), 2 * n * k)
        row = {}
        for m in (8, 16):
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            q1 = device_ms(_cycled(lambda cs: ql.quantized_matmul(x, cs[0], cs[1], k), codes_list))
            lib = device_ms(_cycled(lambda w: F.linear(x, w), dense))
            plain_ms = device_ms(_cycled(lambda cs: plain(x, cs[0], cs[1], k), codes_list))
            deq = device_ms(_cycled(lambda cs: F.linear(x, dequantize_int8(
                cs[0], cs[1], torch.bfloat16)), codes_list))
            nbytes = n * k + n * 4 + m * (k + n) * 2
            bms, by = bound_ms(nbytes, 2.0 * m * n * k)
            row[m] = dict(ms=q1, bound_ms=bms, bound_by=by, library_ms=lib, plain_ms=plain_ms,
                          dequant_linear_ms=deq)
            print(f"[quantized] Q1 int8 x bf16 N={n} K={k} M={m}: {q1:.4f} ms, bound {bms:.4f} ms "
                  f"({by}), bf16 F.linear {lib:.4f} ms, plain quantized_dot {plain_ms:.4f} ms, "
                  f"dequantize then F.linear {deq:.4f} ms")
        by_shape[f"{n}x{k}"] = row
        del codes_list, dense

    # the rows sweep: Q1 against Q2's route (widening, then torch.mm) at each shape
    sweep = {}
    for n, k in QUANT_SHAPES:
        codes_list = _cold(lambda i: _quantized_weights(gen, n, k, "int8"), n * k)
        times = []
        for m in QUANT_SWEEP_ROWS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            q1 = device_ms(_cycled(lambda cs: ql.quantized_matmul(x, cs[0], cs[1], k), codes_list))
            q2 = device_ms(_cycled(lambda cs: ql._widened_matmul(x, cs[0], cs[1], k), codes_list))
            times.append((m, q1, q2))
        sweep[f"{n}x{k}"] = {m: (q1, q2) for m, q1, q2 in times}
        crossover = next((m for m, q1, q2 in times if q1 > q2), None)
        print(f"[quantized] sweep N={n} K={k} (int8 x bf16), M: Q1 ms / Q2 route ms: "
              + ", ".join(f"{m}: {q1:.4f}/{q2:.4f}" for m, q1, q2 in times)
              + f"; Q1 first slower at M={crossover} (ROW_THRESHOLD {ql.ROW_THRESHOLD})")
        del codes_list

    n, k = QUANT_MAIN_SHAPE
    main = by_shape[f"{n}x{k}"][QUANT_MAIN_ROWS]
    q1_entry = dict(name="quantized_matmul", route="cuda",
                    source="transformers_tpu_torch/csrc/quantized_linear.cu",
                    replaces="transformers_tpu/quantizers/weight_only.py:104 (quantized_dot, no "
                             "pallas_call: XLA fuses the widening into the dot)",
                    max_abs_err=max(e for (r, *_), (e, *_) in worst.items() if r == "q1"),
                    ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"], library_ms=main["library_ms"],
                    shape=f"int8 x bf16, N={n} K={k} M={QUANT_MAIN_ROWS}",
                    note="library_ms: bf16 F.linear at the same shape (no PyTorch call "
                         "multiplies int8 codes by bf16 activations)",
                    by_shape=by_shape, sweep_q1_q2_ms=sweep)
    codes_list = _cold(lambda i: _quantized_weights(gen, n, k, "int8"), n * k)
    wms = device_ms(_cycled(lambda cs: ql.widen_codes(cs[0], k, torch.bfloat16), codes_list))
    wplain = device_ms(_cycled(lambda cs: ql.widen_codes_plain(cs[0], k, torch.bfloat16),
                               codes_list))
    wlib = device_ms(_cycled(lambda cs: cs[0].to(torch.bfloat16), codes_list))
    wbms, wby = bound_ms(n * k * 3, 0.0)
    del codes_list
    q2_entry = dict(name="widen_codes", route="cuda",
                    source="transformers_tpu_torch/csrc/quantized_linear.cu",
                    replaces="transformers_tpu/quantizers/weight_only.py:104 (quantized_dot's "
                             "operand widening, fused by XLA; no pallas_call)",
                    max_abs_err=max(e for (r, *_), (e, *_) in worst.items() if r == "q2"),
                    ms=wms, plain_ms=wplain, bound_ms=wbms, bound_by=wby, library_ms=wlib,
                    shape=f"int8 -> bf16, N={n} K={k}",
                    note="library_ms: codes.to(torch.bfloat16); max_abs_err: the whole route "
                         "(widening, torch.mm, scale) against quantized_dot")
    print(f"[quantized] Q2 widen int8 -> bf16 N={n} K={k}: {wms:.4f} ms, bound {wbms:.4f} ms "
          f"({wby}), plain {wplain:.4f} ms, codes.to(bf16) {wlib:.4f} ms")
    return [q1_entry, q2_entry]


# --------------------------------------------------------------------- (c)
def _wrappers() -> dict:
    from transformers_tpu_torch.ops.flash_attention import (flash_attention, flash_bwd_dkv,
                                                            flash_bwd_dq)
    from transformers_tpu_torch.ops.decode_attention import decode_attention
    from transformers_tpu_torch.ops.fused_decode import fused_decode_attention
    from transformers_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                            paged_decode_combine)
    from transformers_tpu_torch.ops.quantized_linear import quantized_matmul, widen_codes

    return {"flash_fwd": flash_attention, "fused_decode": fused_decode_attention,
            "paged_decode": paged_decode_attention, "paged_decode_combine": paged_decode_combine,
            "flash_bwd_dkv": flash_bwd_dkv, "flash_bwd_dq": flash_bwd_dq,
            "static_decode": decode_attention, "quantized_matmul": quantized_matmul,
            "widen_codes": widen_codes}


def _expected(**counts) -> dict:
    """Launch counts of every kernel: those given, 0 for the others."""
    return {name: counts.get(name, 0) for name in _wrappers()}


def _reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def _timed(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def check_load_path(seed: int, card: str) -> None:
    """Full width, depth cut to 2 layers: save with the port's safetensors
    writer, read back with from_pretrained, and hold the weights and logits
    to the model that was saved."""
    from transformers_tpu_torch import AutoModelForCausalLM, LlamaConfig, LlamaForCausalLM
    from transformers_tpu_torch.ops import cuda_build

    cfg = LlamaConfig(**dict(GEOMETRY, num_hidden_layers=2), dtype="bfloat16")
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    ckpt = cuda_build.BUILD_DIR / "smoke_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        save_ms = _timed(lambda: model.save_pretrained(ckpt))
        size = sum(f.stat().st_size for f in ckpt.iterdir())
        holder = {}
        load_ms = _timed(lambda: holder.update(m=AutoModelForCausalLM.from_pretrained(ckpt)))
        loaded = holder["m"]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    report = loaded.load_report
    if report.missing_keys or report.unexpected_keys or report.mismatched_keys:
        raise AssertionError(f"load report not clean: {report}")
    if loaded.dtype != torch.bfloat16:
        raise AssertionError(f"from_pretrained gave {loaded.dtype}, config says bfloat16")
    for name, p in model.named_parameters():
        if not torch.equal(p, loaded.get_parameter(name)):
            raise AssertionError(f"{name} changed in the save/load round trip")
    ids = torch.arange(1, 17, device="cuda")[None] * 997
    with torch.inference_mode():
        same = torch.equal(model(ids).logits, loaded(ids).logits)
    if not same:
        raise AssertionError("logits differ after the save/load round trip")
    print(f"[load] 2-layer full-width checkpoint, {size / 1e9:.2f} GB: save {save_ms:.0f} ms, "
          f"from_pretrained {load_ms:.0f} ms; weights and logits identical ({card})")


def build_model(seed: int):
    """The 32-layer Llama-3-8B-geometry model in bf16, random weights from
    ``seed``; phases (c) and (d) share it."""
    from transformers_tpu_torch import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**GEOMETRY, max_position_embeddings=PROMPT + NEW, bos_token_id=None,
                      eos_token_id=None, pad_token_id=0)
    return LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)


@contextlib.contextmanager
def no_host_sync():
    """Any synchronising CUDA call inside raises (``set_sync_debug_mode("error")``):
    a stream or device synchronisation, a copy to pageable host memory, an
    ``item()``. The decode loops' deliberate reads (``cuda_build.read_back``,
    an event wait after a copy to pinned memory) are not such calls."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _program_bytes(model) -> tuple:
    """(bytes of the decode program's cache, scales of the int8 cache included;
    of its other buffers)."""
    prog = model._decode_program
    c = prog.cache
    cache = sum(t.numel() * t.element_size() for t in c.keys + c.values
                + getattr(c, "key_scales", []) + getattr(c, "value_scales", []))
    bufs = sum(t.numel() * t.element_size() for t in (prog.ids, prog.mask, prog.rope_last,
                                                         prog.next_tok, prog.live, prog.finished))
    return cache, bufs


def _median_ms(run, reps: int = 3) -> float:
    return sorted(_timed(run) for _ in range(reps))[reps // 2]


def check_generate(model, seed: int, card: str) -> dict:
    """Phase (c): greedy generate with the decode step replayed from its CUDA
    graph, against the uncaptured step loop (``_generate(graph=False)``) on the
    same inputs: ids bitwise equal, launch counts exact for both; the replays
    run under ``no_host_sync``. Then sampled at one seed (top-k, top-p) and
    greedy with processors, each graph against the step loop, bitwise. The
    calls use ``decode_pad_multiple=NEW``, so the prefill-only runs (1 new
    token) share the 32-token program and nothing is captured twice."""
    cfg = model.config
    layers = cfg.num_hidden_layers
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ids = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    mask = (torch.arange(PROMPT, device="cuda")[None, :]
            >= torch.tensor(PADS, device="cuda")[:, None]).to(torch.int32)
    ids = ids.masked_fill(mask == 0, 0)
    kw = dict(attention_mask=mask, prompt_pad_multiple=PROMPT, decode_pad_multiple=NEW)

    def graph(**extra):
        return model.generate(ids, **kw, **extra)

    def eager(**extra):
        return model._generate(ids, graph=False, **kw, **extra)

    # the first call of the signature: prefill, one decode step run for real,
    # the capture, then replays; what the program holds stays on the card
    model._decode_program = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    first = graph(max_new_tokens=NEW)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - alloc0 - first.numel() * first.element_size()
    held_reserved = torch.cuda.memory_reserved() - reserved0
    cache_bytes, buf_bytes = _program_bytes(model)
    capture_ms = model._decode_program.graph.capture_ms
    eager(max_new_tokens=NEW)  # warm-up of the step loop's own allocations

    expected = _expected(flash_fwd=layers, fused_decode=layers * (NEW - 1))
    runs = {}
    for name, run in (("graph", graph), ("uncaptured", eager)):
        _reset_counts()
        if name == "graph":
            with no_host_sync():
                out = run(max_new_tokens=NEW)
        else:
            out = run(max_new_tokens=NEW)
        torch.cuda.synchronize()
        counts = _read_counts()
        print(f"[generate] {name}: launches {counts}, expected {expected} ({layers} layers, "
              f"1 prefill, {NEW - 1} decode steps)")
        if counts != expected:
            raise AssertionError(f"{name}: the main path did not go through the kernels as "
                                 f"required")
        runs[name] = (out, counts)
    out, counts = runs["graph"]
    if not torch.equal(out, runs["uncaptured"][0]) or not torch.equal(out, first):
        raise AssertionError("generate: the graph's ids differ from the uncaptured step loop's")
    if out.shape != (BATCH, PROMPT + NEW) or not torch.equal(out[:, :PROMPT], ids):
        raise AssertionError(f"generate returned {tuple(out.shape)} or changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("generated ids outside the vocabulary")
    print(f"[generate] graph == uncaptured step loop, bitwise (greedy); the graph's replays ran "
          f"under set_sync_debug_mode('error')")

    timing = {}
    for name, run in (("graph", graph), ("uncaptured", eager), ("uncaptured", eager),
                      ("graph", graph)):
        prefill = _median_ms(lambda: run(max_new_tokens=1))
        total = _median_ms(lambda: run(max_new_tokens=NEW))
        timing.setdefault(name, []).append((prefill, total))
    for name, pairs in timing.items():
        prefill = min(p for p, _ in pairs)
        total = min(t for _, t in pairs)
        decode_tok = (total - prefill) / (NEW - 1)
        timing[name] = total
        print(f"[generate] {name}: B={BATCH} prompt={PROMPT} new={NEW} bf16, 32 layers: prefill "
              f"{prefill:.2f} ms, decode {decode_tok:.3f} ms/step, "
              f"{BATCH * 1e3 / decode_tok:.1f} decode tokens/s, "
              f"{BATCH * NEW * 1e3 / total:.1f} tokens/s over the whole generate "
              f"(best of two medians of 3) ({card})")
    print(f"[generate] graph: capture {capture_ms:.2f} ms (host clock, the first call of the "
          f"signature); the program holds {held / 1e9:.4f} GB allocated (KV cache "
          f"{cache_bytes / 1e9:.4f} GB, buffers {buf_bytes / 1e6:.3f} MB, the graph's own "
          f"{(held - cache_bytes - buf_bytes) / 1e6:.3f} MB) and {held_reserved / 1e9:.4f} GB "
          f"reserved ({card})")
    profile_run("generate (graph)", lambda: graph(max_new_tokens=NEW), timing["graph"], card)
    profile_run("generate (uncaptured step loop)", lambda: eager(max_new_tokens=NEW),
                timing["uncaptured"], card)

    # the streaming route replays the same graph, with a host read of every step
    from transformers_tpu_torch.generation.streamers import BaseStreamer

    class Chunks(BaseStreamer):
        def __init__(self):
            self.chunks = []

        def put(self, value):
            self.chunks.append(value)

        def end(self):
            pass

    streamer = Chunks()
    streamed = graph(max_new_tokens=NEW, streamer=streamer)
    tokens = np.concatenate(streamer.chunks[1:], axis=1) if len(streamer.chunks) > 1 else None
    ok = (torch.equal(streamed, out) and len(streamer.chunks) == NEW + 1
          and np.array_equal(tokens, out[:, PROMPT:].cpu().numpy()))
    print(f"[generate] streaming route (graph replays, a read per step): ids and the streamer's "
          f"prompt + {len(streamer.chunks) - 1} chunks equal the plain route's: {ok}")
    if not ok:
        raise AssertionError("generate: the streaming route differs from the plain route")

    # sampled at one seed: two graph calls and the step loop draw the same ids
    skw = dict(max_new_tokens=NEW, do_sample=True, top_k=50, top_p=0.9, temperature=0.8)
    seeded = lambda: torch.Generator(device="cuda").manual_seed(seed + 3)  # noqa: E731
    s_first = graph(generator=seeded(), **skw)  # captures the sampled step
    with no_host_sync():
        s_graph = graph(generator=seeded(), **skw)
    s_eager = eager(generator=seeded(), **skw)
    same = (torch.equal(s_graph, s_first), torch.equal(s_graph, s_eager))
    differs = int((s_graph[:, PROMPT:] != out[:, PROMPT:]).sum())
    print(f"[generate] sampled (top_k 50, top_p 0.9, temperature 0.8, seed {seed + 3}): graph == "
          f"graph, graph == uncaptured step loop, bitwise: {same}; {differs} of {BATCH * NEW} "
          f"tokens differ from greedy")
    if not all(same) or differs == 0:
        raise AssertionError("sampled generate: the graph does not draw as the step loop does")

    # greedy with processors: EOS ids that greedy decoding reaches early, held
    # off by min_new_tokens
    eos = sorted({int(out[r, PROMPT + 3]) for r in range(3)})
    pkw = dict(max_new_tokens=NEW, repetition_penalty=1.3, no_repeat_ngram_size=3,
               min_new_tokens=8, eos_token_id=eos)
    p_first = graph(**pkw)  # captures the step with its processors
    _reset_counts()
    with no_host_sync():
        p_graph = graph(**pkw)
    torch.cuda.synchronize()
    p_counts = _read_counts()
    _reset_counts()
    p_eager = eager(**pkw)
    torch.cuda.synchronize()
    e_counts = _read_counts()
    same = (torch.equal(p_graph, p_first), torch.equal(p_graph, p_eager), p_counts == e_counts)
    differs = int((p_graph[:, PROMPT:] != out[:, PROMPT:]).sum())
    print(f"[generate] processors (repetition_penalty 1.3, no_repeat_ngram_size 3, min_new_tokens "
          f"8, eos {eos}): graph == graph, graph == uncaptured step loop bitwise, equal launches "
          f"{same} (fused_decode {p_counts['fused_decode']}); {differs} of {BATCH * NEW} tokens "
          f"differ from plain greedy")
    if not all(same) or differs == 0:
        raise AssertionError("generate with processors: the graph differs from the step loop")
    teacher_force(model, out, mask)
    return counts


def profile_run(label: str, run, wall_ms: float, card: str) -> list:
    """Device busy time of one run from torch.profiler (kernel time summed
    over the run), against the unprofiled wall time and the profiled run's
    own; and the kernels that take the most device time. Returns the
    per-kernel averages (empty when the profiler saw no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    # device events only; a user annotation (the optimizer's
    # "Optimizer.step#AdamW.step" range) spans kernels already counted
    t0 = time.perf_counter()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("Optimizer.")]
    print(f"[profile] {label}: the trace read in {time.perf_counter() - t0:.1f} s")
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("[profile] the profiler recorded no device time: busy share not measured")
        return []
    print(f"[profile] {label}: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"(unprofiled), idle share {1 - busy_ms / wall_ms:.3f}; of the profiled run's "
          f"{profiled_ms:.2f} ms, {1 - busy_ms / profiled_ms:.3f} ({card})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")
    ours = [(m.group(1), e) for e in kernels
            if (m := re.search(r"((?:flash_(?:fwd|bwd)|fused_decode|static_decode|paged_split|"
                               r"paged_combine)\w*kernel)", e.key))]
    if ours:
        print(f"[profile]   the port's kernels: " + ", ".join(
            f"{name} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for name, e in ours))
    return kernels


def teacher_force(model, seq, prompt_mask, quant=None) -> None:
    """The generated sequence through the kernel path (prefill of all but the
    last token, then one decode step) and through the plain path (eager
    attention, no cache, no kernel), against the same model in float32 as
    the reference. The kernel path must be no further from float32 than twice
    the plain bf16 path is: both are bf16 through 32 layers, and they round
    at different places (f32 rope in the decode kernel, f32 probabilities in
    both kernels)."""
    b, total = seq.shape
    mask = torch.cat([prompt_mask, torch.ones((b, total - PROMPT), dtype=torch.int32,
                                              device="cuda")], dim=1)
    pos = (mask.cumsum(-1) - 1).clamp_min(0)
    with torch.inference_mode():
        cache = model.init_cache(b, total)
        model(seq[:, :-1], attention_mask=mask, position_ids=pos[:, :-1], past_key_values=cache,
              cache_position=0, logits_to_keep=1)
        kernel = model(seq[:, -1:], attention_mask=mask, position_ids=pos[:, -1:],
                       past_key_values=cache, cache_position=total - 1).logits[:, -1].float()
    [(plain_all, ref)] = plain_and_f32_logits(model, [(seq, mask, pos)], quant)
    plain = plain_all[:, -1].float()
    agree = float((plain_all[:, PROMPT - 1:-1].argmax(-1) == seq[:, PROMPT:]).float().mean())
    hold_to_plain("teacher-force", kernel, plain, ref,
                  f"greedy tokens = plain argmax at {agree:.3f} of generated positions")


@contextlib.contextmanager
def plain_quantized():
    """Quantized Linears compute through the plain ``quantized_dot`` (the codes
    widened in f32 by PyTorch ops: no kernel) instead of Q1 / Q2."""
    from transformers_tpu_torch.core import module
    from transformers_tpu_torch.ops.quantized_linear import code_type
    from transformers_tpu_torch.quantizers.weight_only import quantized_dot, unpack_int4_codes

    real = module.quantized_linear

    def plain(x, codes, scale, *, in_features):
        w = unpack_int4_codes(codes) if code_type(codes, in_features) == "int4" else codes
        y = quantized_dot(x.reshape(-1, in_features), w, scale, x.dtype)
        return y.reshape(*x.shape[:-1], codes.shape[0])

    module.quantized_linear = plain
    try:
        yield
    finally:
        module.quantized_linear = real


def plain_and_f32_logits(model, batches, quant=None) -> list:
    """For each (ids, mask, positions) batch: the logits of every position
    through the plain path (eager attention, no cache, no kernel; quantized
    Linears through the plain ``quantized_dot``) of ``model``, and the last
    position's logits of the same model in float32 (the reference; a model
    quantized with ``quant`` keeps its codes and scales and computes the
    quantized product in f32)."""
    from transformers_tpu_torch import LlamaForCausalLM, quantize_params

    out = []
    with torch.inference_mode(), plain_quantized():
        _reset_counts()
        model.config.attn_implementation = "eager"
        for ids, mask, pos in batches:
            out.append([model(ids, attention_mask=mask, position_ids=pos).logits])
        model.config.attn_implementation = None
        if any(_read_counts().values()):
            raise AssertionError("the plain path launched a kernel")
        ref_model = LlamaForCausalLM(model.config, dtype=torch.float32, device="cuda")
        if quant is not None:
            quantize_params(ref_model, quant)  # the layout; the codes come from ``model``
        ref_model.load_state_dict(model.state_dict())
        ref_model.config.attn_implementation = "eager"
        for item, (ids, mask, pos) in zip(out, batches):
            item.append(ref_model(ids, attention_mask=mask, position_ids=pos,
                                  logits_to_keep=1).logits[:, -1])
        ref_model.config.attn_implementation = None
        del ref_model
        torch.cuda.empty_cache()
    return out


def hold_to_plain(label: str, kernel, plain, ref, note: str) -> None:
    """The kernel path's last-position logits must be finite and no further
    from float32 than twice the plain bf16 path is."""
    err_kernel = max_err(kernel, plain)
    err_plain_f32 = max_err(plain, ref)
    err_kernel_f32 = max_err(kernel, ref)
    finite = bool(torch.isfinite(kernel).all())
    print(f"[{label}] last-position logits (|max| {float(plain.abs().max()):.3f}): "
          f"|kernel - plain| {err_kernel:.4f}, |plain - f32| {err_plain_f32:.4f}, "
          f"|kernel - f32| {err_kernel_f32:.4f}; {note}")
    if not finite or err_kernel_f32 > 2 * err_plain_f32:
        raise AssertionError(f"{label}: kernel path logits disagree with the plain path")


# --------------------------------------------------------------------- (d)
def cb_prompts(seed: int, vocab: int) -> list:
    """CB_REQUESTS prompts of 64-512 tokens from ``seed``; those in CB_SHARED
    open with one CB_PREFIX-token prefix and run at least 32 tokens past it."""
    rng = np.random.default_rng(seed + 2)
    prefix = rng.integers(1, vocab, size=CB_PREFIX)
    prompts = []
    for i in range(CB_REQUESTS):
        if i in CB_SHARED:
            tail = rng.integers(1, vocab, size=int(rng.integers(CB_PREFIX + 32, 513)) - CB_PREFIX)
            ids = np.concatenate([prefix, tail])
        else:
            ids = rng.integers(1, vocab, size=int(rng.integers(64, 513)))
        prompts.append([int(t) for t in ids])
    return prompts


def cb_engine(model, steps_per_sync: int, graph: bool):
    """A fresh engine; ``graph`` False makes its runner run each decode step
    uncaptured (the reference the graphs are held to)."""
    from transformers_tpu_torch.generation.continuous_batching import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(model, steps_per_sync=steps_per_sync, **CB_ENGINE)
    engine.runner._capture = graph
    return engine


def run_cb(engine, prompts, tag: str, strict: bool = False):
    """Serve ``prompts`` (CB_NEW new tokens each, greedy) through ``engine``.
    Returns the generated ids per request, the wall ms, the host-clock ms and
    device decode steps of the engine steps that ran decode and no prefill
    (each such step ends in a host read), and the runner's counts of this run.
    ``strict``: the runner's decode calls run under ``no_host_sync``."""
    from transformers_tpu_torch.generation.continuous_batching import RequestState

    for i, p in enumerate(prompts):
        engine.add_request(RequestState(request_id=f"{tag}{i}", prompt_ids=p,
                                        max_new_tokens=CB_NEW))
    runner = engine.runner
    names = ("prefill_chunks", "single_token_chunks", "decode_steps", "prefill_tokens")
    before = {n: getattr(runner, n) for n in names}
    if strict:
        calls = {n: getattr(runner, n) for n in ("decode_step", "decode_multi")}

        def checked(fn):
            def call(*args, **kw):
                with no_host_sync():
                    return fn(*args, **kw)
            return call

        for n, fn in calls.items():
            setattr(runner, n, checked(fn))
    results, decode_ms, decode_steps = {}, 0.0, 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        while engine.has_work():
            chunks = runner.prefill_chunks + runner.single_token_chunks
            steps = runner.decode_steps
            ts = time.perf_counter()
            events = engine.step()
            if runner.prefill_chunks + runner.single_token_chunks == chunks \
                    and runner.decode_steps > steps:
                decode_ms += (time.perf_counter() - ts) * 1e3
                decode_steps += runner.decode_steps - steps
            for ev in events:
                if ev.status in ("finished", "failed"):
                    results[ev.request_id] = ev
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        if strict:
            for n in calls:
                delattr(runner, n)
    bad = [rid for rid, ev in results.items() if ev.status != "finished"]
    if len(results) != len(prompts) or bad:
        raise AssertionError(f"continuous batching: {len(results)} of {len(prompts)} requests "
                             f"came back, not finished: {bad}")
    generated = [results[f"{tag}{i}"].generated_ids for i in range(len(prompts))]
    ran = {n: getattr(runner, n) - before[n] for n in names}
    return generated, wall, decode_ms, decode_steps, ran


def shifted(prompts, vocab: int, by: int) -> list:
    """``prompts`` with every token moved by ``by`` within [1, vocab): the same
    lengths and shared prefix, so the engine schedules the same chunks,
    buckets and windows, and no page matches the originals'."""
    return [[(t - 1 + by) % (vocab - 1) + 1 for t in p] for p in prompts]


def check_cb(model, seed: int, card: str) -> tuple:
    """Phase (d): continuous batching at full width on the 32-layer model, at
    one sync per step and one per 16, each with an engine whose decode steps
    replay captured graphs and one that runs them uncaptured. Each engine
    first serves the prompts shifted by one token id (its graphs are captured
    and cuBLAS warmed there, on the same schedule), then the measured prompts;
    the graph engines' decode calls run under ``no_host_sync``. Tokens of the
    two engines must be equal for every request, launch counts exact. Returns
    the launches at one sync per step and the graph engines' (generated
    tokens/s, ms per device decode step) by steps per sync."""
    layers = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    prompts = cb_prompts(seed, vocab)
    outputs, warm, counts_by_sync, engines, walls, rates = {}, {}, {}, {}, {}, {}
    for steps in (1, 16):
        for graph in (True, False):
            name = "graph" if graph else "uncaptured"
            engine = cb_engine(model, steps, graph)
            warm[(steps, name)] = run_cb(engine, shifted(prompts, vocab, 1), "warm")[0]
            _reset_counts()
            generated, wall, decode_ms, decode_steps, r = run_cb(engine, prompts, "r",
                                                                 strict=graph)
            counts = _read_counts()
            paged = layers * (r["decode_steps"] + r["single_token_chunks"])
            expected = _expected(flash_fwd=layers * r["prefill_chunks"], paged_decode=paged,
                                 paged_decode_combine=paged)
            print(f"[cb] {name}, steps_per_sync={steps}: launches {counts}, expected {expected} "
                  f"({layers} layers, {r['prefill_chunks']} prefill chunks, "
                  f"{r['single_token_chunks']} one-token chunks, {r['decode_steps']} decode "
                  f"steps)")
            if counts != expected:
                raise AssertionError("the CB path did not go through the kernels as required")
            if any(len(g) != CB_NEW or min(g) < 0 or max(g) >= vocab for g in generated):
                raise AssertionError(f"a request did not return {CB_NEW} ids inside the "
                                     f"vocabulary")
            cached = sum(len(p) for p in prompts) - r["prefill_tokens"]
            print(f"[cb] {name}, steps_per_sync={steps}: {CB_REQUESTS} requests, prompts "
                  f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens ({cached} served "
                  f"from the prefix cache), {CB_NEW} new tokens each, bf16, {layers} layers: wall "
                  f"{wall:.2f} ms, {CB_REQUESTS * CB_NEW * 1e3 / wall:.1f} generated tokens/s, "
                  f"decode {decode_ms / max(decode_steps, 1):.3f} ms per device step over "
                  f"{decode_steps} steps of decode-only engine steps; "
                  f"{len(engine.runner._programs)} decode programs ({card})")
            outputs[(steps, name)], engines[(steps, name)] = generated, engine
            walls[(steps, name)] = wall
            if graph:
                counts_by_sync[steps] = counts
                rates[steps] = (CB_REQUESTS * CB_NEW * 1e3 / wall,
                                decode_ms / max(decode_steps, 1))
        same = (outputs[(steps, "graph")] == outputs[(steps, "uncaptured")]
                and warm[(steps, "graph")] == warm[(steps, "uncaptured")])
        print(f"[cb] steps_per_sync={steps}: graph engine's tokens == uncaptured engine's for "
              f"every request, in the warm-up (where each graph's first call runs the step for "
              f"real and captures it) and the measured run: {same}")
        if not same:
            raise AssertionError("CB: the graph engine's tokens differ from the uncaptured one's")
    same = sum(a == b for x, y in zip(outputs[(1, "graph")], outputs[(16, "graph")])
               for a, b in zip(x, y))
    print(f"[cb] steps_per_sync 1 vs 16: {same} of {CB_REQUESTS * CB_NEW} generated tokens "
          f"equal (bf16 GEMMs of other batch shapes round differently; random weights give "
          f"near-ties)")
    # the graph engine only, to keep the run well inside its time limit
    profile_run("continuous batching, 16 steps per sync (graph)",
                lambda: run_cb(engines[(16, "graph")], shifted(prompts, vocab, 2), "prof"),
                walls[(16, "graph")], card)
    teacher_force_cb(model, engines[(16, "graph")], prompts, outputs[(16, "graph")])
    return counts_by_sync[1], rates


def teacher_force_cb(model, engine, prompts, generated) -> None:
    """Two finished requests (one of the shared prefix, the shortest prompt)
    through the CB kernel path: chunked prefill of all but the last token over
    fresh pages, then one decode step; held to the plain path as in phase (c)."""
    picks = [CB_SHARED[0], min(range(len(prompts)), key=lambda i: len(prompts[i]))]
    runner, bs = engine.runner, CB_ENGINE["block_size"]
    budget = CB_ENGINE["token_budget"]
    kernel, batches = [], []
    with torch.inference_mode():
        for i in picks:
            seq = prompts[i] + generated[i]
            table = engine.bm.allocate(-(-len(seq) // bs))
            for start in range(0, len(seq) - 1, budget):
                runner.prefill_chunk(seq[start:min(start + budget, len(seq) - 1)], table, start)
            kernel.append(runner.decode_step([seq[-1]], [table], [len(seq) - 1]).float())
            engine.bm.free(table)
            ids = torch.tensor([seq], device="cuda")
            batches.append((ids, torch.ones_like(ids, dtype=torch.int32),
                            torch.arange(len(seq), device="cuda")[None]))
    plain_ref = plain_and_f32_logits(model, batches)
    plain = torch.cat([p[:, -1].float() for p, _ in plain_ref])
    ref = torch.cat([r for _, r in plain_ref])
    agree = sum(int((p[0, len(prompts[i]) - 1:-1].argmax(-1)
                     == torch.tensor(generated[i], device="cuda")).sum())
                for (p, _), i in zip(plain_ref, picks)) / (len(picks) * CB_NEW)
    hold_to_plain("cb teacher-force", torch.cat(kernel), plain, ref,
                  f"requests {picks}; greedy tokens = plain argmax at {agree:.3f} of generated "
                  f"positions")


# --------------------------------------------------------------------- (f)
# quantized generate: the JAX bench's serving leg (int8 weight-only, batch 16)
QUANT_BATCH = 16
QUANT_SMALL_LAYERS = 4  # int4, fp8 and the int8 KV cache


def quant_config(method: str):
    from transformers_tpu_torch import (Fp8WeightOnlyConfig, Int4WeightOnlyConfig,
                                        Int8WeightOnlyConfig)

    return {"int8": Int8WeightOnlyConfig, "int4": Int4WeightOnlyConfig,
            "fp8": Fp8WeightOnlyConfig}[method]()


def build_quantized(seed: int, layers: int, method: str):
    """The Llama-3-8B-geometry model of ``build_model`` (the same random bf16
    weights at the same seed) cut to ``layers``, its Linear weights quantized
    on the card, one tensor at a time."""
    from transformers_tpu_torch import LlamaConfig, LlamaForCausalLM, quantize_params

    cfg = LlamaConfig(**dict(GEOMETRY, num_hidden_layers=layers),
                      max_position_embeddings=PROMPT + NEW, bos_token_id=None, eos_token_id=None,
                      pad_token_id=0)
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    quantize_params(model, quant_config(method))
    torch.cuda.empty_cache()
    return model


def quant_inputs(seed: int, vocab: int) -> tuple:
    """QUANT_BATCH prompts of PROMPT tokens, left-padded by PADS twice over."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    ids = torch.randint(1, vocab, (QUANT_BATCH, PROMPT), generator=gen, device="cuda")
    pads = torch.tensor(PADS * (QUANT_BATCH // len(PADS)), device="cuda")
    mask = (torch.arange(PROMPT, device="cuda")[None, :] >= pads[:, None]).to(torch.int32)
    return ids.masked_fill(mask == 0, 0), mask


def weight_bytes(model) -> tuple:
    """(bytes of all weights, of the quantized Linears' codes and scales)."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    quantized = sum(m.weight.numel() * m.weight.element_size()
                    + m.weight_scale.numel() * m.weight_scale.element_size()
                    for m in model.modules() if getattr(m, "weight_scale", None) is not None)
    return total, quantized


class WeightCopyWatch:
    """Records each op, run inside ``watch()``, that makes a floating-point
    tensor of at least ``numel`` elements: a dense copy of a quantized weight
    (the smallest has 1024 x 4096 elements) would be one. Nothing else in a
    decode step at batch 16 is that large."""

    def __init__(self, numel: int):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils._pytree import tree_flatten

        seen = self.seen = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                inputs = {t.untyped_storage().data_ptr()
                          for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)}
                for t in tree_flatten(out)[0]:
                    # a new tensor, not a view or the input itself (``.to`` of a weight
                    # already in the compute type returns it)
                    if isinstance(t, torch.Tensor) and t.is_floating_point() \
                            and t.numel() >= numel \
                            and t.untyped_storage().data_ptr() not in inputs:
                        seen.append((str(func), tuple(t.shape), str(t.dtype)))
                return out

        self.mode = Mode

    @contextlib.contextmanager
    def watch(self):
        with self.mode():
            yield


def _generate_runs(model, ids, mask):
    kw = dict(attention_mask=mask, prompt_pad_multiple=PROMPT, decode_pad_multiple=NEW)

    def graph(**extra):
        return model.generate(ids, **kw, **extra)

    def eager(**extra):
        return model._generate(ids, graph=False, **kw, **extra)

    return graph, eager


def _first_call(model, graph, watch=None) -> dict:
    """The signature's first call (prefill, one step for real, the capture,
    replays), with each decode step run under ``watch``; what the program holds
    afterwards."""
    from transformers_tpu_torch.generation.utils import StaticDecode

    model._decode_program = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0 = torch.cuda.memory_allocated()
    step = StaticDecode.step
    if watch is not None:
        def watched(self, *args):
            with watch.watch():
                return step(self, *args)
        StaticDecode.step = watched
    try:
        first = graph(max_new_tokens=NEW)
    finally:
        StaticDecode.step = step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - alloc0 - first.numel() * first.element_size()
    cache_bytes, buf_bytes = _program_bytes(model)
    return dict(first=first, held=held, cache=cache_bytes, bufs=buf_bytes,
                capture_ms=model._decode_program.graph.capture_ms,
                replay=dict(model._decode_program.graph.launches))


def _graph_vs_step_loop(label, model, graph, eager, expected, **extra) -> tuple:
    """The graph path (under ``no_host_sync``) and the uncaptured step loop on
    the same inputs: ids bitwise equal, launch counts exact for both. Returns
    the graph path's ids and its launch counts, read just after its run."""
    runs = {}
    for name, run in (("graph", graph), ("uncaptured", eager)):
        _reset_counts()
        if name == "graph":
            with no_host_sync():
                out = run(max_new_tokens=NEW, **extra)
        else:
            out = run(max_new_tokens=NEW, **extra)
        torch.cuda.synchronize()
        counts = _read_counts()
        if counts != expected:
            raise AssertionError(f"{label} {name}: launches {counts}, expected {expected}")
        runs[name] = out, counts
    if not torch.equal(runs["graph"][0], runs["uncaptured"][0]):
        raise AssertionError(f"{label}: the graph's ids differ from the uncaptured step loop's")
    out, counts = runs["graph"]
    if int(out.min()) < 0 or int(out.max()) >= model.config.vocab_size:
        raise AssertionError(f"{label}: generated ids outside the vocabulary")
    print(f"[quantized generate] {label}: graph == uncaptured step loop, bitwise (greedy, the "
          f"graph's replays under set_sync_debug_mode('error')); launches {expected} for both")
    return out, counts


def check_quantized_generate(bf16_model, seed: int, card: str) -> tuple:
    """Phase (f), first part: int8 weight-only generate at batch 16 on the
    32-layer model, the JAX bench's serving leg: the graph path against the
    uncaptured step loop, launches exact (Q1 224 per decode step from the
    replays, Q2 224 per prefill, K2 32 per step), no Q2 and no dense copy of a
    quantized weight in the decode step; then int8 and bf16 (``bf16_model``, the
    same weights unquantized) timed in turns, and both profiled. Returns the
    int8 path's launches, the int8 model and its generated ids and mask."""
    layers = bf16_model.config.num_hidden_layers
    ids, mask = quant_inputs(seed, bf16_model.config.vocab_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = build_quantized(seed, layers, "int8")
    torch.cuda.synchronize()
    total, quantized = weight_bytes(model)
    bf16_total, _ = weight_bytes(bf16_model)
    print(f"[quantized generate] int8 weight-only model built and quantized on the card in "
          f"{time.perf_counter() - t0:.1f} s: weights {total / 1e9:.3f} GB ({quantized / 1e9:.3f} "
          f"GB of int8 codes and f32 scales; bf16 embeddings, lm_head, norms), bf16 model "
          f"{bf16_total / 1e9:.3f} GB ({card})")
    runs = {"int8": _generate_runs(model, ids, mask), "bf16": _generate_runs(bf16_model, ids, mask)}
    watch = WeightCopyWatch(1024 * 4096)
    first = {"int8": _first_call(model, runs["int8"][0], watch),
             "bf16": _first_call(bf16_model, runs["bf16"][0])}
    replay = first["int8"]["replay"]
    names = {w: n for n, w in _wrappers().items()}
    per_replay = {names[w]: n for w, n in replay.items()}
    print(f"[quantized generate] int8 decode graph, launches per replay: {per_replay}; large "
          f"floating-point tensors made in the decode step (a dense weight copy would be one): "
          f"{watch.seen}")
    if per_replay != {"quantized_matmul": 7 * layers, "fused_decode": layers} or watch.seen:
        raise AssertionError("int8 decode step: not Q1 alone for every projection")
    expected = _expected(flash_fwd=layers, fused_decode=layers * (NEW - 1),
                         quantized_matmul=7 * layers * (NEW - 1), widen_codes=7 * layers)
    out, counts = _graph_vs_step_loop("int8 weight-only, batch 16, 32 layers", model,
                                      *runs["int8"], expected)
    if not torch.equal(out, first["int8"]["first"]):
        raise AssertionError("int8 generate: the capturing call's ids differ from the replays'")
    _reset_counts()
    bf16_out = runs["bf16"][0](max_new_tokens=NEW)
    torch.cuda.synchronize()
    if _read_counts() != _expected(flash_fwd=layers, fused_decode=layers * (NEW - 1)):
        raise AssertionError("bf16 generate at batch 16: launches differ")
    same = int((bf16_out[:, PROMPT:] == out[:, PROMPT:]).sum())
    print(f"[quantized generate] int8 vs bf16 (same weights before quantization): {same} of "
          f"{QUANT_BATCH * NEW} generated tokens equal")

    timing = {}
    for name in ("bf16", "int8", "int8", "bf16"):
        graph = runs[name][0]
        prefill = _median_ms(lambda: graph(max_new_tokens=1))
        whole = _median_ms(lambda: graph(max_new_tokens=NEW))
        timing.setdefault(name, []).append((prefill, whole))
    for name in ("bf16", "int8"):
        prefill = min(p for p, _ in timing[name])
        whole = min(t for _, t in timing[name])
        step_ms = (whole - prefill) / (NEW - 1)
        f = first[name]
        timing[name] = whole
        print(f"[quantized generate] {name} graph: B={QUANT_BATCH} prompt={PROMPT} new={NEW}, "
              f"{layers} layers: prefill {prefill:.2f} ms, decode {step_ms:.3f} ms/step, "
              f"{QUANT_BATCH * 1e3 / step_ms:.1f} decode tokens/s, "
              f"{QUANT_BATCH * NEW * 1e3 / whole:.1f} tokens/s over the whole generate; capture "
              f"{f['capture_ms']:.2f} ms; the program holds {f['held'] / 1e9:.4f} GB (KV cache "
              f"{f['cache'] / 1e9:.4f} GB); weights {weight_bytes(model if name == 'int8' else bf16_model)[0] / 1e9:.3f} GB "
              f"(best of two medians of 3, in turns bf16, int8, int8, bf16) ({card})")
    for name in ("int8", "bf16"):
        profile_run(f"generate {name}, batch {QUANT_BATCH} (graph)",
                    lambda: runs[name][0](max_new_tokens=NEW), timing[name], card)
    return counts, model, out, mask


def check_quantized_small(seed: int, card: str) -> dict:
    """Phase (f), last part, at 4 layers of the same width: int4 and fp8
    weight-only generate at batch 16, each graph against the uncaptured step
    loop bitwise with exact launches, and its teacher-forced logits held to
    the plain path; then int8 weights over the int8 KV cache
    (``cache_implementation="quantized"``, which takes the unfused attention
    route: no K2), graph against step loop, and the cache's bytes."""
    layers = QUANT_SMALL_LAYERS
    counts = {}
    ids = mask = None
    for method in ("int4", "fp8", "int8"):
        model = build_quantized(seed, layers, method)
        if ids is None:
            ids, mask = quant_inputs(seed, model.config.vocab_size)
        graph, eager = _generate_runs(model, ids, mask)
        extra = {}
        fused = layers * (NEW - 1)
        if method == "int8":
            extra, fused = dict(cache_implementation="quantized"), 0
        label = f"{method} weight-only, batch {QUANT_BATCH}, {layers} layers" + (
            ", int8 KV cache" if extra else "")
        graph(max_new_tokens=NEW, **extra)  # the signature's first call: the capture
        expected = _expected(flash_fwd=layers, fused_decode=fused,
                             quantized_matmul=7 * layers * (NEW - 1), widen_codes=7 * layers)
        out, counts[method] = _graph_vs_step_loop(label, model, graph, eager, expected, **extra)
        if extra:
            cache = model._decode_program.cache
            if type(cache).__name__ != "QuantizedKVCache" or cache.keys[0].dtype != torch.int8:
                raise AssertionError("cache_implementation='quantized' did not build the int8 cache")
            cache_bytes, _ = _program_bytes(model)
            bf16_bytes = 2 * layers * QUANT_BATCH * GEOMETRY["num_key_value_heads"] \
                * cache.max_len * GEOMETRY["head_dim"] * 2
            print(f"[quantized generate] int8 KV cache: {cache_bytes / 1e6:.3f} MB (int8 codes "
                  f"and f32 scales per token and head) against {bf16_bytes / 1e6:.3f} MB for the "
                  f"bf16 cache of the same geometry ({card})")
        else:
            teacher_force(model, out, mask, quant_config(method))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return counts


def check_quantized_cb(model, seed: int, card: str, bf16_rates: dict) -> dict:
    """Phase (f): phase (d)'s traffic through an int8 weight-only engine at 16
    steps per sync, graph and uncaptured (each warmed by the shifted traffic),
    tokens equal for every request; launches exact: Q1 224 per device decode
    step and per prefill chunk of at most ROW_THRESHOLD tokens, Q2 224 per
    longer chunk; each decode graph replays Q1 and no Q2."""
    from transformers_tpu_torch.ops.quantized_linear import ROW_THRESHOLD

    layers = model.config.num_hidden_layers
    vocab = model.config.vocab_size
    prompts = cb_prompts(seed, vocab)
    steps, outputs = 16, {}
    for graph in (True, False):
        name = "graph" if graph else "uncaptured"
        engine = cb_engine(model, steps, graph)
        run_cb(engine, shifted(prompts, vocab, 1), "warm")
        runner = engine.runner
        lengths = []
        chunk = runner.prefill_chunk

        def recorded(input_ids, *args, **kw):
            lengths.append(len(input_ids))
            return chunk(input_ids, *args, **kw)

        runner.prefill_chunk = recorded
        _reset_counts()
        try:
            generated, wall, decode_ms, decode_steps, r = run_cb(engine, prompts, "r",
                                                                 strict=graph)
        finally:
            del runner.prefill_chunk
        counts = _read_counts()
        small = sum(1 for n in lengths if n <= ROW_THRESHOLD)
        paged = layers * (r["decode_steps"] + r["single_token_chunks"])
        expected = _expected(flash_fwd=layers * r["prefill_chunks"], paged_decode=paged,
                             paged_decode_combine=paged,
                             quantized_matmul=7 * layers * (r["decode_steps"] + small),
                             widen_codes=7 * layers * (len(lengths) - small))
        print(f"[quantized cb] int8 {name}, steps_per_sync={steps}: launches {counts}, expected "
              f"{expected} ({r['prefill_chunks']} prefill chunks, {r['single_token_chunks']} "
              f"one-token chunks, {small} chunks of at most {ROW_THRESHOLD} tokens, "
              f"{r['decode_steps']} decode steps)")
        if counts != expected:
            raise AssertionError("the int8 CB path did not go through the kernels as required")
        if graph:
            for key, prog in runner._programs.items():
                per = {n: prog.graph.launches.get(w, 0) for n, w in _wrappers().items()}
                if per["widen_codes"] or not per["quantized_matmul"] \
                        or per["quantized_matmul"] != 7 * per["paged_decode"]:
                    raise AssertionError(f"CB decode graph {key}: launches per replay {per}")
        rate, step_ms = CB_REQUESTS * CB_NEW * 1e3 / wall, decode_ms / max(decode_steps, 1)
        bf16_rate, bf16_step = bf16_rates[steps]
        print(f"[quantized cb] int8 {name}, steps_per_sync={steps}, {layers} layers: wall "
              f"{wall:.2f} ms, {rate:.1f} generated tokens/s, decode {step_ms:.3f} ms per device "
              f"step over {decode_steps} steps; bf16 graph engine (phase d, same call): "
              f"{bf16_rate:.1f} tokens/s, {bf16_step:.3f} ms per device step ({card})")
        outputs[name] = generated
        if graph:
            graph_counts = counts
    same = outputs["graph"] == outputs["uncaptured"]
    print(f"[quantized cb] int8 graph engine's tokens == uncaptured engine's for every request: "
          f"{same}")
    if not same:
        raise AssertionError("int8 CB: the graph engine's tokens differ from the uncaptured one's")
    return graph_counts


# --------------------------------------------------------------------- (e)
def train_rows(seed: int, vocab: int) -> list:
    """TRAIN_ROWS rows of TRAIN_SEQ tokens from ``seed``, right-padded to the
    lengths of ``_train_lengths`` (attention_mask 0, labels -100 on the pad);
    no position_ids, so attention takes the flash kernels."""
    rng = np.random.default_rng(seed + 4)
    rows = []
    for n in _train_lengths(seed):
        ids = np.zeros(TRAIN_SEQ, np.int64)
        ids[:n] = rng.integers(1, vocab, n)
        mask = (np.arange(TRAIN_SEQ) < n).astype(np.int32)
        rows.append({"input_ids": ids, "attention_mask": mask,
                     "labels": np.where(mask == 1, ids, -100)})
    return rows


def _loss_and_qkv_grads(model, batch) -> tuple:
    """The loss of ``batch`` and the gradients of layer 0's q/k/v projection
    weights, which reach layer 0 only through every layer's attention
    backward."""
    model.zero_grad(set_to_none=True)
    loss = model(**batch).loss
    loss.backward()
    attn = model.model.layers[0].self_attn
    grads = [getattr(attn, n).weight.grad.clone() for n in ("q_proj", "k_proj", "v_proj")]
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def check_train_grads(model, batch) -> None:
    """Phase (e)'s hold-to-plain, on one row before the optimizer exists: the
    kernel path's loss and layer-0 q/k/v gradients, the plain bf16 path's
    (eager attention) and the same weights in float32 (eager). The kernel
    path's relative gradient error against float32 must be at most twice the
    plain path's, and its loss error at most twice the plain path's plus
    1e-3: the bar phases (c) and (d) hold logits to, carried to gradients."""
    from transformers_tpu_torch import LlamaForCausalLM

    layers = model.config.num_hidden_layers
    _reset_counts()
    loss_k, g_k = _loss_and_qkv_grads(model, batch)
    torch.cuda.synchronize()
    counts = _read_counts()
    expected = _expected(flash_fwd=layers, flash_bwd_dq=layers, flash_bwd_dkv=layers)
    if counts != expected:
        raise AssertionError(f"kernel path launches {counts}, expected {expected}")
    _reset_counts()
    model.config.attn_implementation = "eager"
    loss_p, g_p = _loss_and_qkv_grads(model, batch)
    ref_model = LlamaForCausalLM(model.config, dtype=torch.float32, device="cuda")
    ref_model.load_state_dict(model.state_dict())
    loss_f, g_f = _loss_and_qkv_grads(ref_model, batch)
    model.config.attn_implementation = None
    del ref_model
    gc.collect()
    torch.cuda.empty_cache()
    if any(_read_counts().values()):
        raise AssertionError("the plain path launched a kernel")

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).float()) / torch.linalg.vector_norm(b.float()))

    rel_k = [rel(a, b) for a, b in zip(g_k, g_f)]
    rel_p = [rel(a, b) for a, b in zip(g_p, g_f)]
    finite = all(bool(torch.isfinite(g).all()) for g in g_k) and math.isfinite(loss_k)
    print(f"[train grads] one row, {layers} layers: loss kernel {loss_k:.6f}, plain bf16 "
          f"{loss_p:.6f}, f32 {loss_f:.6f}; layer-0 q/k/v weight gradients, relative error vs "
          f"f32: kernel {', '.join(f'{x:.4e}' for x in rel_k)}, plain "
          f"{', '.join(f'{x:.4e}' for x in rel_p)}; launches {counts}")
    if (not finite or any(a > 2 * b for a, b in zip(rel_k, rel_p))
            or abs(loss_k - loss_f) > 2 * abs(loss_p - loss_f) + 1e-3):
        raise AssertionError("train: the kernel path's loss or gradients disagree with the plain "
                             "path")


def _step_clock():
    """A TrainerCallback that records each optimizer step's host-clock ms
    (ending in a synchronize) and its peak device memory."""
    from transformers_tpu_torch import TrainerCallback

    class StepClock(TrainerCallback):
        def __init__(self):
            self.ms, self.peak = [], []

        def on_step_begin(self, args, state, control, **kwargs):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            self.t0 = time.perf_counter()

        def on_step_end(self, args, state, control, **kwargs):
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - self.t0) * 1e3)
            self.peak.append(torch.cuda.max_memory_allocated())

    return StepClock()


def _trainer(model, rows, clock, **kw):
    from transformers_tpu_torch import Trainer, TrainingArguments
    from transformers_tpu_torch.ops import cuda_build

    args = TrainingArguments(
        output_dir=str(cuda_build.BUILD_DIR / "smoke_trainer"),
        per_device_train_batch_size=TRAIN_ROWS, learning_rate=1e-4,
        lr_scheduler_type="constant", weight_decay=0.01, max_grad_norm=1.0, logging_steps=1,
        save_strategy="no", seed=0, **kw)
    return Trainer(model, args, train_dataset=rows, callbacks=[clock])


def check_train(seed: int, card: str) -> dict:
    """Phase (e): Trainer.train() at the Llama-3-8B width, depth cut to 4
    layers (1.9e9 parameters: f32 weights, gradients and AdamW's two moments
    take 16 bytes each, ~31 GB; all 32 layers would need ~128 GB)."""
    from transformers_tpu_torch import LlamaConfig, LlamaForCausalLM
    from transformers_tpu_torch.data import default_data_collator

    print(f"[train] device memory allocated before the phase {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB, peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
    cfg = LlamaConfig(**dict(GEOMETRY, num_hidden_layers=TRAIN_LAYERS),
                      max_position_embeddings=TRAIN_SEQ, bos_token_id=None, eos_token_id=None,
                      pad_token_id=0)
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                             device="cuda").init_weights(seed)
    n_params = sum(p.numel() for p in model.parameters())
    non_embedding = sum(p.numel() for n, p in model.named_parameters()
                        if "embed_tokens" not in n)
    rows = train_rows(seed, cfg.vocab_size)
    batch = default_data_collator(rows)
    one_row = {k: v[:1].cuda() for k, v in batch.items()}
    check_train_grads(model, one_row)

    # 5 optimizer steps over the same 4 rows; step 1 warms up
    clock = _step_clock()
    trainer = _trainer(model, rows, clock, max_steps=TRAIN_STEPS)
    _reset_counts()
    trainer.train()
    torch.cuda.synchronize()
    counts = _read_counts()
    layers, steps = TRAIN_LAYERS, TRAIN_STEPS
    expected = _expected(flash_fwd=layers * steps, flash_bwd_dq=layers * steps,
                         flash_bwd_dkv=layers * steps)
    losses = [e["loss"] for e in trainer.state.log_history if "loss" in e]
    print(f"[train] launches {counts}, expected {expected} ({layers} layers, {steps} steps); "
          f"losses {losses}")
    if counts != expected:
        raise AssertionError("the training path did not go through the kernels as required")
    if len(losses) != steps or not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"train: losses not finite or not falling: {losses}")

    step_ms = float(np.median(clock.ms[1:]))
    positions = TRAIN_ROWS * TRAIN_SEQ  # the card computes the pad too
    tokens = sum(_train_lengths(seed))  # non-pad positions: what a user trains on
    h, d = cfg.num_attention_heads, cfg.head_dim
    attn_flops = layers * 3 * 4 * TRAIN_ROWS * TRAIN_SEQ ** 2 * h * d / 2
    flops = 6 * non_embedding * positions + attn_flops
    mfu = flops / (step_ms / 1e3 * BF16_FLOPS_PER_S)
    print(f"[train] {n_params / 1e9:.3f}e9 parameters ({non_embedding / 1e9:.3f}e9 non-embedding), "
          f"{TRAIN_ROWS} x {TRAIN_SEQ} tokens (lengths {_train_lengths(seed)}), AdamW, f32 weights, "
          f"bf16 compute: step ms {', '.join(f'{x:.2f}' for x in clock.ms)}; median of steps "
          f"2-{steps} {step_ms:.2f} ms, {tokens * 1e3 / step_ms:.1f} training tokens/s "
          f"(non-pad), {positions * 1e3 / step_ms:.1f} positions/s, mfu "
          f"{mfu:.4f} ({flops / 1e12:.2f} TFLOP per step at {BF16_FLOPS_PER_S / 1e12:.0f} "
          f"TFLOP/s); peak memory {max(clock.peak) / 1e9:.2f} GB (step 1: "
          f"{clock.peak[0] / 1e9:.2f} GB) ({card})")
    kernels = profile_run("train step", lambda: trainer.training_step([batch]), step_ms, card)
    groups = {"flash kernels (K1, K4, K5)": ("flash_",), "cuBLAS GEMMs": ("nvjet", "gemm"),
              "multi-tensor (AdamW, clip, zero)": ("multi_tensor_apply",)}
    sums = {g: 0.0 for g in (*groups, "other")}
    for e in kernels:
        group = next((g for g, keys in groups.items() if any(k in e.key for k in keys)), "other")
        sums[group] += e.self_device_time_total / 1e3
    if kernels:
        print("[profile] train step by kind: " + ", ".join(f"{g} {ms:.2f} ms"
                                                          for g, ms in sums.items()))

    # one step with gradient checkpointing: K1 runs again in the recompute
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    clock_gc = _step_clock()
    trainer = _trainer(model, rows, clock_gc, max_steps=1, gradient_checkpointing=True)
    _reset_counts()
    trainer.train()
    torch.cuda.synchronize()
    counts_gc = _read_counts()
    expected_gc = _expected(flash_fwd=2 * layers, flash_bwd_dq=layers, flash_bwd_dkv=layers)
    print(f"[train] gradient checkpointing, one step: launches {counts_gc}, expected "
          f"{expected_gc}; {clock_gc.ms[0]:.2f} ms, peak memory {clock_gc.peak[0] / 1e9:.2f} GB "
          f"against {clock.peak[0] / 1e9:.2f} GB for the first step without it ({card})")
    if counts_gc != expected_gc:
        raise AssertionError("gradient checkpointing did not go through the kernels as required")
    # the step's peak is AdamW's; forward + backward alone shows the activations
    del trainer
    gc.collect()
    peaks = {}
    for enable in (False, True):
        model.gradient_checkpointing_enable(enable)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model(**{k: v.cuda() for k, v in batch.items()}).loss.backward()
        torch.cuda.synchronize()
        peaks[enable] = (torch.cuda.max_memory_allocated() - base) / 1e9
        model.zero_grad(set_to_none=True)
    print(f"[train] forward + backward of the 4 x {TRAIN_SEQ} batch, peak above the weights: "
          f"{peaks[False]:.2f} GB without gradient checkpointing, {peaks[True]:.2f} GB with it "
          f"(gradients included) ({card})")
    model.gradient_checkpointing_disable()
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[card] {card}")
    start = time.perf_counter()
    clock = [start]

    def lap(label: str) -> None:
        now = time.perf_counter()
        print(f"[time] {label}: {now - clock[0]:.1f} s")
        clock[0] = now

    phase_build()
    lap("phase (a), build")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    _reset_counts()
    kernels = [check_flash(gen), check_decode(gen, args.seed), *check_paged(gen, args.seed),
               check_static_decode(gen, args.seed)]
    bwd, k1_train = check_flash_bwd(gen, args.seed)
    kernels[0].update(k1_train)
    kernels += bwd
    check_reference_cases(gen)
    kernels += check_quantized_linear(gen)
    phase_b = _read_counts()  # K7 serves no path: its launches are phase (b)'s checks
    lap("phase (b), kernel holds")
    check_load_path(args.seed, card)
    model = build_model(args.seed)
    paths = {"generate": check_generate(model, args.seed, card)}
    lap("phase (c), load and generate")
    paths["continuous_batching"], cb_rates = check_cb(model, args.seed, card)
    lap("phase (d), continuous batching")
    paths["quantized_generate"], qmodel, qout, qmask = check_quantized_generate(
        model, args.seed, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    teacher_force(qmodel, qout, qmask, quant_config("int8"))
    paths["quantized_continuous_batching"] = check_quantized_cb(qmodel, args.seed, card, cb_rates)
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    for method, counts in check_quantized_small(args.seed, card).items():
        paths[f"quantized_{method}_small"] = counts
    lap("phase (f), quantized weights and KV cache")
    paths["train"] = check_train(args.seed, card)
    lap("phase (e), training")
    serves = {"paged_decode": "continuous_batching", "paged_decode_combine": "continuous_batching",
              "flash_bwd_dkv": "train", "flash_bwd_dq": "train",
              "quantized_matmul": "quantized_generate", "widen_codes": "quantized_generate"}
    for k in kernels:
        # each kernel's launches on the path it serves; every path's counts beside
        if k["name"] == "static_decode":
            k["launches"] = phase_b["static_decode"]
            k["note"] = ("the JAX package runs this kernel from no model path (only "
                         "tests/ops/test_decode_attention.py calls it): launches are phase "
                         "(b)'s checks, and every path's count is held at 0")
        else:
            k["launches"] = paths[serves.get(k["name"], "generate")][k["name"]]
        k["launches_by_path"] = {p: c[k["name"]] for p, c in paths.items()}
    print(json.dumps({"kernels": kernels}))
    print(f"[time] smoke total: {time.perf_counter() - start:.1f} s")
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
