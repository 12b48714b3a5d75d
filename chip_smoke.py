#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``transformers_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N] [--only-encoders]

``--only-encoders`` runs the build (a) and then phase (n) alone, and prints
no result line: a quick check of the encoders, not a smoke run.

Phases, in order; any failure exits non-zero:

(a) build every CUDA kernel from ``transformers_tpu_torch/csrc`` (one nvcc per
    source, all at once), print the card's name and power limit, and each
    tensor-core flash-forward build's (``mma.sync`` at head_dim 64-128,
    ``wgmma`` at 256), the flash backward's ``wgmma`` builds (K4, K5 at
    256) and split-KV decode build's (K2, K6, K7) registers, shared memory
    and spills from ``nvcc -Xptxas -v``, and those of the quantized
    product's builds (Q1, Q2) by name; a K2, K7 or ``wgmma`` K1, K4 or K5
    build that spills fails the run;
(b) hold each kernel against its plain PyTorch version at the main paths'
    shapes, in bf16, and time the kernel, the plain version and one PyTorch
    library call that computes the same function (a yardstick only: the port
    never calls it), beside the least time the card could take; then hold
    them on the cases of the reference's tests/ops files in float32, float16
    and bf16, at head_dim 64, 96, 128 and 256. The fused decode (K2, split-KV)
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
    (Q1 ``quantized_matmul`` from the codes, on the tensor cores for bf16 and
    f16; Q2 ``widen_codes`` then ``torch.mm``) is held against the plain
    ``quantized_dot`` for int8, int4 and fp8 codes x bf16, f16 and f32
    activations at the four Llama-3-8B projection shapes and 1, 3, 8 and 16
    rows and the rows above up to ``ROW_THRESHOLD`` (Q2 at 1-16 and 256),
    plus int4 rows with a tail past the last whole chunk; the tensor-core Q1
    also against ``quantized_matmul_split_plain`` at its split of K, and run
    twice (bitwise-equal outputs required); Q1 is timed at 8 and 16 rows
    beside its bound, ``torch._weight_int8pack_mm`` (the library yardstick),
    bf16 ``F.linear`` and the plain versions, each weight read from device
    memory, and Q1 and Q2's route are swept over 1-128 rows (the sweep that
    set ``ROW_THRESHOLD``); then K1, K4/K5, K2 and K6 at head_dim 96 in the
    three storage types, and K1, K2 and K6 held (absolutely and relative to
    the output's scale) and timed beside their bounds and SDPA at phase (i)'s
    shapes: Gemma-3-12B's prefill (4 x 1536 slots, 16 query heads over 8 kv
    heads, head_dim 256, window 1024 and none), decode step and CB decode
    with the window, and Phi-3-mini's (head_dim 96). K1's bf16/f16
    head_dim-256 route (``wgmma``, TMA) is held there and on the reference
    cases at head_dim 256 (a window over left pads, a query-head group of 8
    with softcap 50, a 190-row CB chunk over 1700 slots with the window) also
    relative to the output's scale, against ``flash_attention_tiled_plain``
    at its own kv tile, and twice (bitwise-equal outputs required); K4 and
    K5 are held and timed beside SDPA's backward at Phi-3-mini's training
    shape (head_dim 96, 4 x 2048, 32 heads, window 2047), Gemma-3-12B's
    (head_dim 256, 16 over 8 heads, window 1024 and none) and Gemma-2-9B's
    (head_dim 256, 16 over 8, window 4096, softcap 50: no SDPA call computes
    it); their bf16/f16 head_dim-256 route (``wgmma``, TMA) is also run
    twice there and on the reference cases at 256 (bitwise-equal outputs
    required). K1, K2 and K6 are also held and timed at phase (j)'s shapes
    (Qwen3-30B-A3B: 32 query heads over 4 kv heads, a group of 8, head_dim
    128) and phase (k)'s (OLMoE-1B-7B's group of 1, 16 heads over 16, at
    phase (c)'s shapes; Laguna's group of 6, 48 over 8, with its 512-slot
    window at Gemma-3-12B's long contexts) and phase (l)'s (K1 and K6 at
    ERNIE-4.5-21B-A3B's odd group of 5, 20 heads over 4, and at Command-R7B's
    4096-slot window over prompts of 5120 and contexts of 4633-5131; K2 at
    MiniMax-M2's group of 6 with no window) and phase (m)'s (K1 and K6 at
    GLM-4.5-Air's group of 12, 96 heads over 8; K1 at Mistral4's decode
    step, one query row over 144 slots). The mixture-of-experts products
    (``ops/moe.py``; library calls, no kernel of the port) are held at
    Qwen3-30B-A3B's layer (128 experts of 768 over hidden 2048, 8 a token)
    at 8 and 1024 rows: the ``dense`` and
    ``ragged`` routes against each other and a per-expert loop in float32
    and bf16, the ragged route twice (bitwise) and under the sync check,
    and both timed beside their bound and ``torch.bmm`` over all experts;
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
(h) (run after (d), on its model) serving: the port's ``AutoTokenizer`` from the
    repo's ``tests/fixtures/bpe48k`` (48k byte-level BPE, Llama-3 split; the
    model keeps its 128256-token vocabulary, ids from 48006 decode to nothing)
    and the port's OpenAI-compatible server (``ServeEngine`` + ``OpenAIServer``,
    in this process, on 127.0.0.1 and a free port) over phase (d)'s engine at 16
    steps per sync. 12 prompts of 90-500 tokens cut from mixed text (English,
    code, CJK, figures, whitespace runs) at ``--seed``; ``generate_batch`` on
    their prompt ids gives the expected 64 greedy ids each; then 6
    ``/v1/completions`` (4 streamed), 4 ``/v1/chat/completions`` (2 streamed;
    the fixture has no chat template, so the fallback prompt) and 2
    ``/v1/responses`` (1 streamed) are sent at once from client threads. The
    manager's intake is held until all 12 are in and hands them over in
    ``generate_batch``'s order, so the engine runs the same schedule. Every
    text and usage must equal the expected, every stream's deltas add up to
    its text, and K1, K6 and its merge launch as the engine's prefill chunks
    and decode steps say; then a stream closed after its 4th delta must be
    cancelled with its pages returned. Prints served tokens/s beside
    ``generate_batch``'s, time to first delta and between deltas at the
    client, and the tokenizer's encode rate through the C++ BPE and the plain
    Python merge (host);
(g) (run after (h), on its model) the other generation routes. Beam search:
    rows 0 and 4 of phase (c)'s prompts, 4 beams (8 cache rows), 32 new
    tokens, 2 returned, through ``generate(num_beams=4)``, its step captured
    as a CUDA graph; the graph path (under the sync check) against the
    uncaptured step loop, sequences and scores bitwise, launches exact (K1
    once per layer, K2 once per layer per step run), once without EOS and
    once with ``early_stopping=True`` and an EOS from the first run's best
    beam; the scores held to the returned sequences teacher-forced through
    the plain path and float32; prefill ms, ms per beam step, capture ms,
    memory held, a profile, and the cache reorder's device ms. Assisted
    decoding at batch 1 (prompt 128, 64 new tokens) with a draft of the
    Llama-3.2-1B geometry (16 layers, head_dim 64, tied, llama3 rope), prompt
    lookup, the target as its own draft, and a sampled run: launches exact
    from each model's forwards by route, the acceptance rate, ms per new
    token against greedy graph ``generate``, the share of tokens equal to
    greedy. At 4 layers of each geometry in float32: the card's beam search
    equals the port's CPU run (sequences, scores within 1e-4), and the draft,
    prompt-lookup and self-assisted outputs equal greedy ``generate``'s bit
    for bit (the self-assisted run accepting every proposal). Watermarking
    at the full vocabulary: green-list masks and SynthID g-values equal the
    CPU's, one SynthID step within 1e-5;
(f) (run after (g), while (c)'s model is alive) weight-only quantization: the
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
(i) (run after (f), when no other model is held) the Llama-skeleton families.
    Gemma-3-12B's text decoder at full width, its depth cut to 24 of 48
    layers (the text_config of google/gemma-3-12b-it: 5 of each
    6 layers sliding with a 1024-slot window and the local rope table,
    head_dim 256, tied 262208-token vocabulary; bf16, random weights from
    ``--seed``, ~23.5 GB at 48 layers): a 2-layer
    checkpoint round trip through ``AutoModelForCausalLM`` (no ``lm_head`` in
    the file); static generate at batch 4 over 1536-slot prompts left-padded
    by 0/64/128/256 (every row's context past the window), 32 new tokens,
    greedy, graph against the uncaptured step loop bitwise under the sync
    check, K1 24 per prefill and K2 24 per step, timed and profiled; CB with 8
    requests of 1100-2000 tokens at 16 steps per sync, a graph engine and an
    uncaptured one (each warmed first, as in (d)) giving equal tokens,
    launches exact, the graph engine profiled; the generated tokens
    teacher-forced against a float32 run (the bf16 model moved off the card
    first). Then Mistral-7B, Qwen2.5-7B, Qwen3-8B, Phi-3-mini (head_dim 96),
    Gemma-7B, Gemma-2-9B and the mixture-of-experts Mixtral-8x7B and
    Qwen1.5-MoE-A2.7B (its shared expert) at 4 layers of their published
    widths: static generate at batch 4, prompt 128, 16 new tokens, graph
    against step loop bitwise, launches exact by route (K2 never for Gemma-2,
    whose softcap keeps decode on the plain path), logits teacher-forced;
(j) (run after (i), when no other model is held) Qwen3-30B-A3B at full width,
    its depth cut to 24 of 48 layers (128 experts of 768, 8 a
    token; bf16, random weights from ``--seed``, 61 GB at 48 layers, built
    on the card): a 2-layer checkpoint
    round trip (one tensor per expert in the file); static generate at phase
    (c)'s shape under each experts route, ``dense`` and ``ragged``, graph
    against step loop bitwise under the sync check, K1 24 per prefill and K2
    24 per step; prefill ms, decode ms/step, tokens/s, idle share and peak
    memory per route beside the step's weight-stream bound (the experts the
    rows touch, over the HBM copy rate measured here), and the device time
    split by span (experts and their products, router, attention and its
    kernel, norms, lm_head) from a profile with host events; the routes'
    prompt logits held to each other and float32; continuous batching (8
    requests of 90-502 tokens, 16 steps per sync, ragged route), the graph
    engine against an uncaptured one, K1 and K6 exact, and its split by
    span; the generated tokens teacher-forced against float32 computed from
    the same bf16 weights (a float32 copy of 48 layers would take 122 GB);
(k) (run after (j), when no other model is held) the mixture-of-experts
    families whose bases the port has. OLMoE-1B-7B at full width and depth
    (allenai/OLMoE-1B-7B-0924: 16 layers, 16 over 16 heads, 64 experts of
    1024, 8 a token, not renormalized; 13.8 GB) as phase (j)'s model: the
    2-layer checkpoint round trip, static generate under both routes (graph
    against step loop, K1 16 per prefill and K2 16 per step, timed,
    profiled, split by span), the routes' logits, continuous batching on
    the ragged route (K1, K6 exact), the tokens teacher-forced against
    float32. gpt-oss-20b at full width, its depth cut to 8 of 24 layers
    (openai/gpt-oss-20b: layers alternating window 128 and full, 64 over 8
    heads at head_dim 64, sinks, 32 experts of 2880, 4 a token, yarn; 41.8
    GB at 24 layers, ~15 GB at 8): the round trip
    (its stacked experts whole), static generate graph against step loop
    with no kernel launched (no kernel takes its sinks, as in the JAX
    package), timed, profiled and split by span with the eager attention
    apart, teacher-forced. Then Phi-3.5-MoE (sparsemixer, LayerNorms,
    LongRoPE) and Laguna (three sliding layers and one full, whose half-width
    rope keeps its decode step off K2; layer 0 dense) at 4 layers of their
    widths, as phase (i)'s families. Each MoE teacher-force also prints how
    often the bf16 path's router picks other experts than float32's;
(l) (run after (k), when no other model is held) the MoE families that
    needed a dense base first, and the bases. ERNIE-4.5-21B-A3B at full width
    and depth (baidu/ERNIE-4.5-21B-A3B-PT: 28 layers, 20 over 4 heads, layer
    0 dense, 64 experts of 1536, 6 a token, 2 shared experts, a float32
    router, interleaved rope; 43.7 GB) as phase (k)'s OLMoE: static generate
    under both routes (K1 28 per prefill; K2 never, as the JAX package keeps
    interleaved rope off its fused decode: the eager cached attention), the
    routes' logits, continuous batching, teacher-forced. Command-R7B at full
    width and depth (CohereForAI/c4ai-command-r7b-12-2024: 32 layers, window
    4096 on three of each four, the fourth with no rope; logit_scale 0.25;
    tied 256000-token vocabulary): static generate at batch 2 over 5120-slot
    prompts left-padded by 0 and 512, 32 new (K1 32, K2 never), timed,
    profiled, split by span, peak memory; continuous batching of 8 requests
    of 4600-5100 tokens (K1 and K6 with the window); teacher-forced. Then
    OLMo-2-1124-7B, MiniMax-M2, Command-R v01, Cohere2-MoE, HunYuan-7B (alpha
    rope) and Hunyuan-A13B at 4 layers of their widths and ERNIE-4.5-0.3B at
    its 18, as phase (i)'s families (K2 only for OLMo-2 and MiniMax-M2);
(m) (run after (l), when no other model is held) the DeepSeek tree.
    DeepSeek-V2-Lite at full width and depth (deepseek-ai/DeepSeek-V2-Lite:
    27 layers, 16 heads of multi-head latent attention with a 512-wide kv
    latent, q/k 128 + 64 rope and v 128, layer 0 dense, 64 experts of 1408,
    6 a token by softmax, 2 shared, yarn factor 40; 31.4 GB) and
    DeepSeek-V3 at full width cut to 4 layers (DeepseekV3Config's defaults:
    3 dense layers, then 256 experts of 2048 in 8 groups, 8 a token from 4
    groups by sigmoid scores and a choice bias, one shared; ~30 GB): the
    2-layer round trip, the CB engine's refusal, static generate under
    both routes, graph against step loop with no kernel launched (the
    values are narrower than the keys: the eager attention, as in JAX),
    timed against the weight stream, profiled, split by span with the MLA's
    share of a decode step (its block, the history's re-expansion through
    ``kv_b_proj``, the eager attention), the routes' logits, teacher-forced.
    GLM-4.5-Air at full width cut to 4 layers (96 over 8 heads, half of
    each head rotated, biases on q/k/v): static generate (K1 per layer; no
    K2, as in JAX), CB (K1 and K6 at the group of 12), teacher-forced.
    Then dots.llm1, Solar-Open and Mistral4 at 4 layers of their configs'
    widths, as phase (i)'s families (Mistral4's MLA through K1 at the
    prefill and at every decode step);
(n) (run after (m), when no other model is held) the encoders, the task
    heads and the text pipelines. K1's bidirectional mode (``is_causal=False``)
    held to its plain version and to ``flash_attention_tiled_plain``, twice
    bitwise, and timed beside its bound and SDPA with a boolean key-padding
    mask at BERT-large's 32 x 512 (rows right-padded to lengths of 64-512,
    16 heads, head_dim 64) and ModernBERT's global layer (1 x 8192, 12
    heads). Then, through the auto classes, bf16, random weights from
    ``--seed``, at full width and depth: bert-large-uncased sequence
    classification and masked LM at 32 x 512, roberta-large sequence
    classification at 32 x 512, xlm-roberta-large masked LM at 8 x 512 (its
    250002-wide decoder), distilbert-base-uncased sequence classification at
    32 x 512 and ModernBERT-base masked LM at 16 x 512 and 1 x 8192: K1 once a
    layer (ModernBERT's global layers only; its local layers take the eager
    attention, as in JAX), ms a forward, sequences/s, MFU, K1's and the
    eager attention's share of device time (profiler), the leg's peak memory
    (above what was allocated when the leg began), and the head's logits at the live positions no further from float32 than twice
    the plain (eager) path; ``LlamaForSequenceClassification`` on phase
    (c)'s geometry at 32 layers, 8 x 128 with pad ids inside two rows (K1
    causal, the pooled positions checked); then the seven text tasks once
    each through ``pipeline(task, model=<dir>, device="cuda")`` on
    BERT-base-width models and a small Llama saved with a made-up
    30522-entry WordPiece vocabulary, each output's structure checked and
    its ms a call printed;
(e) training at the same width, depth cut to 4 layers (f32 weights, bf16
    compute, random from ``--seed``), after (c)/(d)'s model is freed: layer 0's
    q/k/v gradients and the loss of one row through the kernel path held
    against the plain bf16 path and a float32 run; then ``Trainer.train()``,
    AdamW, 5 steps over 4 rows of 1536-2048 tokens, with launch counts (K1,
    K4 and K5 once per layer per step), step time, tokens/s, MFU, peak
    memory and a profiled step; then one step with gradient checkpointing
    (K1 twice per layer). Then the same on Gemma-3-12B's text decoder at
    its full width, depth cut to 6 layers (one period of its
    ``sliding_window_pattern``: five sliding layers, window 1024, and one
    global, held to the config's pattern; ~37.6 GB of f32 weights,
    gradients and AdamW moments, a step's peak ~75.6 GB, allocated from
    expandable segments): K4 and K5 run their head_dim-256 route, and the
    launches are held by window too (five windowed and one global per step).

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
import os
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
# phase (e)'s Gemma-3-12B leg: one period of its sliding_window_pattern (five
# sliding layers with the 1024-slot window, then one global)
TRAIN_GEMMA3_LAYERS = 6

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
    "d96_causal": (2, 128, 128, 4, 2, 96, None, None, None),
    "d96_padded_window_cap": (2, 100, 300, 8, 2, 96, (0, 37), 64, 30.0),
    # head_dim 256 on the wgmma route: Gemma-2's softcap of 50 at a query-head
    # group of 8, and a continuous-batching prefill chunk of 190 rows (no
    # multiple of 64: the last block's second consumer warpgroup lies past the
    # end) over 1700 slots, window 1024
    "d256_gqa_8_cap_50": (2, 128, 128, 16, 2, 256, None, None, 50.0),
    "d256_cb_chunk_window": (2, 190, 1700, 4, 4, 256, (37, 0), 1024, None),
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
    "d96_gqa_1": (3, 4, 4, 96, 64, 41, [0, 9, 40], 0),
    "d96_gqa_8": (2, 16, 2, 96, 600, 580, [0, 3], 0.05),
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
    "d96_gqa_8": (3, 16, 2, 96, 32, (40, 1, 317), None),
    "d96_gqa_4_window": (3, 8, 2, 96, 16, (100, 48, 700), 40),
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
REPORTED_BUILDS = ("flash_fwd_tc_kernel", "flash_fwd_wg_kernel", "flash_bwd_dq_wg_kernel",
                   "flash_bwd_dkv_wg_kernel", "paged_split_kernel", "paged_combine_kernel",
                   "fused_decode_kernel", "static_decode_kernel", "quantized_linear_tc_kernel")
# the builds reported as one line each (one instantiation per code type and
# row tile: Q1's f32 route, and Q2 per activation type)
SUMMED_BUILDS = ("quantized_linear_kernel", "widen_codes_kernel")
# the split-KV decode builds (K2, K7) and the wgmma builds of K1, K4 and K5 must not spill
NO_SPILL_BUILDS = ("fused_decode_kernel", "static_decode_kernel", "flash_fwd_wg_kernel",
                   "flash_bwd_dq_wg_kernel", "flash_bwd_dkv_wg_kernel")
# the kv tile of K1's bf16/f16 head_dim-256 route (FwdWg::BKV in csrc/flash_fwd.cu)
WG_TILE = 64


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


def _p_spread(q, k, v, qpos, valid, **kw):
    """The mean |v| under each row's probabilities (f32), by which rounding
    every probability once to the storage type can move an output (see
    ``grad_ratio``): for the bf16/f16 routes, which round P; None in f32."""
    from transformers_tpu_torch.ops.flash_attention import flash_attention_plain

    if q.dtype == torch.float32:
        return None
    return flash_attention_plain(q.float(), k.float(), v.float().abs(), qpos, valid, **kw)[0]


def _flash_errors(q, k, v, qpos, valid, **kw) -> tuple[float, float, float]:
    """Max abs error of the kernel's output and logsumexp against the plain
    version's, and the output's worst ``grad_ratio`` at q's GRAD_ULP (a hold
    relative to the output's scale; on the tensor-core routes, bf16 and f16 at
    every head_dim (``mma.sync`` at 64/96/128, ``wgmma`` at 256), with the
    spread their rounded probabilities allow); raises if the two disagree on
    which rows see no slot."""
    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_plain)

    out, lse = flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, return_lse=True, **kw)
    ref, ref_lse = flash_attention_plain(q, k, v, qpos, valid, **kw)
    spread = _p_spread(q, k, v, qpos, valid, **kw)
    torch.cuda.synchronize()
    fin = torch.isfinite(ref_lse)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError("flash: fully masked rows differ")
    return (max_err(out, ref), max_err(lse[fin], ref_lse[fin]),
            grad_ratio(out, ref, GRAD_ULP[q.dtype], spread))


def _flash_wg_holds(q, k, v, qpos, valid, tol: float, **kw) -> dict:
    """K1's bf16/f16 head_dim-256 route (``wgmma``) against
    ``flash_attention_tiled_plain`` at the kernel's own kv tile (WG_TILE),
    which rounds each tile's P once under the same running max: the output
    is held to ``tol`` and to ``grad_ratio`` at most 1 with the probabilities'
    spread (a P whose f32 value lies at a rounding boundary can round either
    way on the two sides: without that term the reading reached 1.2-1.6 at
    outputs near 0); then two calls on the same inputs must be equal bit for
    bit. Returns the readings."""
    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_tiled_plain)

    args = dict(q_positions=qpos, kv_valid=valid, return_lse=True, **kw)
    out, lse = flash_attention(q, k, v, **args)
    out2, lse2 = flash_attention(q, k, v, **args)
    tiled, _ = flash_attention_tiled_plain(q, k, v, qpos, valid, block_kv=WG_TILE, **kw)
    torch.cuda.synchronize()
    err = max_err(out, tiled)
    ratio = grad_ratio(out, tiled, GRAD_ULP[q.dtype], _p_spread(q, k, v, qpos, valid, **kw))
    bitwise = torch.equal(out, out2) and torch.equal(lse, lse2)
    if err > tol or ratio > 1.0 or not bitwise:
        raise AssertionError(f"flash wgmma route against its tiled plain version: max_abs_err "
                             f"{err:.3e} (tol {tol}), grad_ratio {ratio:.4f}, two runs equal "
                             f"bit for bit: {bitwise}")
    return dict(tiled_err=err, tiled_grad_ratio=ratio, bitwise=bitwise)


def flash_timed(q, k, v, qpos, valid, window=None, is_causal: bool = True,
                iters: int = 20) -> dict:
    """K1, its plain version and SDPA (the mask as a boolean tensor) timed on
    these inputs (causal unless told otherwise, the window if given), beside
    the least time the card could take; ``iters`` calls a timed graph."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_plain)

    b, sq, h, d = q.shape
    kw = dict(scale=d ** -0.5, is_causal=is_causal, sliding_window=window)
    ms = device_ms(lambda: flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, **kw),
                   iters=iters)
    plain_ms = device_ms(lambda: flash_attention_plain(q, k, v, qpos, valid, **kw),
                         iters=iters)
    slots = torch.arange(k.shape[1], device="cuda")
    mask = (valid != 0)[:, None, :].expand(b, sq, k.shape[1])
    if is_causal:
        mask = mask & (slots[None, None, :] <= qpos[:, :, None])
    if window:
        mask = mask & (slots[None, None, :] > qpos[:, :, None] - window)
    qt, kt, vt, m4 = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask[:, None]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=m4, scale=kw["scale"], enable_gqa=True), iters=iters)
    # q and out whole, k and v at the live slots only (the kernel skips tiles
    # no row sees, and a dead slot's bytes need not move), lse, the mask data
    live_kv = int((valid != 0).sum()) * k.shape[2] * d * 2
    nbytes = (q.numel() * 2 + live_kv) * q.element_size() + b * h * sq * 4 \
        + (qpos.numel() + valid.numel()) * 4
    bms, by = bound_ms(nbytes, 4.0 * d * h * int(mask.sum()))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


def check_flash(gen) -> dict:
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
        err, lse_err, _ = _flash_errors(q, k, v, qpos, valid, **kw)
        ok = err <= KERNEL_ATOL and lse_err <= LSE_ATOL
        print(f"[flash] {name}: max_abs_err out {err:.3e} (tol {KERNEL_ATOL}) "
              f"lse {lse_err:.3e} (tol {LSE_ATOL})")
        if not ok:
            raise AssertionError(f"flash kernel disagrees with its plain version ({name})")
        if name != "left_padded":
            continue
        # the main path's case: time it
        b, s, h, d = q.shape
        result = dict(name="flash_fwd", route="cuda",
                      source="transformers_tpu_torch/csrc/flash_fwd.cu",
                      replaces="transformers_tpu/ops/pallas/flash_attention.py:190",
                      kernels="bf16/f16 at head_dim 64/96/128: flash_fwd_tc_kernel (mma.sync; "
                              "this entry's shape); bf16/f16 at 256: flash_fwd_wg_kernel "
                              "(wgmma, TMA; at_family_shapes' Gemma-3-12B entries); f32: "
                              "flash_fwd_kernel (CUDA cores)",
                      max_abs_err=err, **flash_timed(q, k, v, qpos, valid))
        print(f"[flash] B={b} S={s} H={h} KVH={k.shape[2]} D={d}: {result['ms']:.4f} ms, plain "
              f"{result['plain_ms']:.4f} ms, sdpa {result['library_ms']:.4f} ms, bound "
              f"{result['bound_ms']:.4f} ms ({result['bound_by']})")
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


def grad_ratio(a: torch.Tensor, ref: torch.Tensor, u: float, spread=None) -> float:
    """Largest |a - ref| / (u * |ref| + u/2 * rms(ref)) over the elements: at
    most 1 where ``a`` holds ``ref`` to GRAD_ULP's bound. ``spread`` (per
    element, f32) adds u/2 * spread to each element's bound: for attention
    whose kernel rounds each probability once to the storage type (K1's
    tensor-core route, as the Pallas kernel's ``p.astype(v.dtype)``), the
    mean of |v| under the probabilities, by which that rounding (at most u/2
    of each p) can move an output."""
    a, ref = a.float(), ref.float()
    rms = ref.square().mean().sqrt()
    bound = u * ref.abs() + 0.5 * u * rms
    if spread is not None:
        bound = bound + 0.5 * u * spread
    return float(((a - ref).abs() / bound.clamp_min(1e-30)).max())


def _bwd_errors(q, k, v, qpos, valid, do, twice: bool = False, **kw) -> tuple[dict, dict]:
    """K5 and K4 against the plain backward on the kernel forward's output
    and logsumexp: per gradient, the max abs error and the worst ratio of
    ``grad_ratio`` (at most 1 to pass). The kernels' dV comes back under
    ``"dv_tensors"`` with the plain one, for the planted-fault check. With
    ``twice``, both kernels run a second time on the same inputs and every
    output (dQ, delta, dK, dV) must be equal bit for bit."""
    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_bwd_plain,
                                                            flash_bwd_dkv, flash_bwd_dq)

    out, lse = flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, return_lse=True, **kw)
    dq, delta = flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, qpos, valid, **kw)
    if twice:
        dq2, delta2 = flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw)
        dk2, dv2 = flash_bwd_dkv(q, k, v, do, lse, delta2, qpos, valid, **kw)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in ((dq, dq2), (delta, delta2), (dk, dk2),
                                                   (dv, dv2))):
            raise AssertionError("flash backward kernels: two runs on the same inputs differ")
        del dq2, delta2, dk2, dv2
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


def _flex_capped(qt, kt, vt, qpos, valid, *, scale, sliding_window, logit_cap, **_) -> tuple:
    """One compiled ``flex_attention`` call on BHSD tensors that computes the
    softcapped function (a tanh ``score_mod`` on the scaled scores; a block
    mask from ``kv_valid``, causality by position and the window; GQA):
    the library yardstick where SDPA has no softcap. The port never calls
    it. Returns its output and a description."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    def score_mod(score, b, h, i, j):
        return logit_cap * torch.tanh(score / logit_cap)

    def mask_mod(b, h, i, j):
        seen = (valid[b, j] != 0) & (j <= qpos[b, i])
        if sliding_window:
            seen = seen & (j > qpos[b, i] - sliding_window)
        return seen

    b, _, s, _ = qt.shape
    block_mask = create_block_mask(mask_mod, b, None, s, kt.shape[2], device=qt.device)
    out = torch.compile(flex_attention, dynamic=False)(
        qt, kt, vt, score_mod=score_mod, block_mask=block_mask, scale=scale, enable_gqa=True)
    return out, ("flex_attention backward (autograd.grad of one torch.compile'd flex_attention "
                 "call: tanh score_mod, block mask from kv_valid, causality and the window, "
                 "enable_gqa)")


def _bwd_timed(q, k, v, qpos, valid, do, **kw) -> dict:
    """K5 (dQ) and K4 (dK/dV) on K1's output and logsumexp, timed between
    CUDA events beside their plain versions, the library's backward and
    their bounds (bf16 inputs); also the mask and its count of visible
    (row, slot) pairs. The library's backward is autograd.grad of one call
    that computes the same function, dQ, dK and dV together, a yardstick
    the port never calls: SDPA with the boolean mask, or, with a softcap,
    ``_flex_capped``, whose dQ is first held to K5's."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.flash_attention import (flash_attention, flash_bwd_dkv,
                                                            flash_bwd_dkv_plain, flash_bwd_dq,
                                                            flash_bwd_dq_plain)

    b, s, h, d = q.shape
    out, lse = flash_attention(q, k, v, q_positions=qpos, kv_valid=valid, return_lse=True, **kw)
    _, delta = flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw)
    t = dict(dq_ms=event_ms(lambda: flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw)),
             dkv_ms=event_ms(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, qpos, valid, **kw)),
             dq_plain_ms=event_ms(lambda: flash_bwd_dq_plain(q, k, v, out, do, lse, qpos, valid,
                                                             **kw), iters=2),
             dkv_plain_ms=event_ms(lambda: flash_bwd_dkv_plain(q, k, v, do, lse, delta, qpos,
                                                               valid, **kw), iters=2))
    slots = torch.arange(s, device="cuda")
    mask = (valid != 0)[:, None, :] & (slots[None, None, :] <= qpos[:, :, None])
    if kw.get("sliding_window"):
        mask &= slots[None, None, :] > qpos[:, :, None] - kw["sliding_window"]
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    do_t = do.transpose(1, 2)
    if kw.get("logit_cap"):  # SDPA has no softcap
        out_t, t["library"] = _flex_capped(qt, kt, vt, qpos, valid, **kw)
        # the yardstick computes the same function: its dQ against K5's
        dq_lib = torch.autograd.grad(out_t, qt, do_t, retain_graph=True)[0].transpose(1, 2)
        dq_ref = flash_bwd_dq(q, k, v, out, do, lse, qpos, valid, **kw)[0].float()
        t["library_dq_err"] = max_err(dq_lib, dq_ref) / float(dq_ref.abs().max())
        if t["library_dq_err"] > 5e-2:
            raise AssertionError(f"the softcapped yardstick's dQ is off K5's by "
                                 f"{t['library_dq_err']:.3e} of |dQ|max")
    else:
        out_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask[:, None],
                                               scale=kw["scale"], enable_gqa=True)
        t["library"] = "SDPA backward (autograd.grad of one SDPA call, boolean mask, enable_gqa)"
    # the best of three reads: single reads of this yardstick have run 25% high
    t["library_ms"] = min(event_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                               retain_graph=True), iters=3)
                          for _ in range(3))
    del out_t
    visible = int(mask.sum())
    q_bytes, kv_bytes = q.numel() * 2, (k.numel() + v.numel()) * 2  # bf16
    fixed = 2 * b * h * s * 4 + (qpos.numel() + valid.numel()) * 4  # lse, delta; mask data
    # K5 reads Q, O, dO, K, V, lse and writes dQ, delta; 3 products
    t["dq_bound"], t["dq_by"] = bound_ms(4 * q_bytes + kv_bytes + fixed, 6.0 * d * h * visible)
    # K4 reads Q, dO, K, V, lse, delta and writes dK, dV; 4 products
    t["dkv_bound"], t["dkv_by"] = bound_ms(2 * q_bytes + 2 * kv_bytes + fixed,
                                           8.0 * d * h * visible)
    return dict(t, mask=mask, visible=visible)


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
                                                            flash_attention_plain)

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
        fwd_err, lse_err, _ = _flash_errors(q, k, v, qpos, valid, **kw)
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
        t = _bwd_timed(q, k, v, qpos, valid, do, **kw)
        mask, visible = t["mask"], t["visible"]
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
        common = dict(route="cuda", source="transformers_tpu_torch/csrc/flash_bwd.cu",
                      library_ms=t["library_ms"], library=t["library"])
        results = [
            dict(name="flash_bwd_dkv",
                 replaces="transformers_tpu/ops/pallas/flash_attention.py:445",
                 max_abs_err=max(errs["dk"], errs["dv"]), ms=t["dkv_ms"],
                 plain_ms=t["dkv_plain_ms"], bound_ms=t["dkv_bound"], bound_by=t["dkv_by"],
                 **common),
            dict(name="flash_bwd_dq",
                 replaces="transformers_tpu/ops/pallas/flash_attention.py:471",
                 max_abs_err=errs["dq"], ms=t["dq_ms"], plain_ms=t["dq_plain_ms"],
                 bound_ms=t["dq_bound"], bound_by=t["dq_by"], **common)]
        print(f"[flash_bwd] B={b} S={s} H={h} KVH={k.shape[2]} D={d}, {visible} visible "
              f"(row, slot) pairs: " + _bwd_times_text(t))
    return results, k1_train


def _bwd_times_text(t: dict) -> str:
    return (f"K4 dK/dV {t['dkv_ms']:.4f} ms (plain {t['dkv_plain_ms']:.4f}, bound "
            f"{t['dkv_bound']:.4f} {t['dkv_by']}), K5 dQ {t['dq_ms']:.4f} ms (plain "
            f"{t['dq_plain_ms']:.4f}, bound {t['dq_bound']:.4f} {t['dq_by']}), "
            + t["library"].split(" (")[0] + f" {t['library_ms']:.4f} ms"
            + (f" (its dQ off K5's by {t['library_dq_err']:.3e} of |dQ|max)"
               if "library_dq_err" in t else ""))


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


def decode_timed(args, pos: int) -> dict:
    """K2 (pos a tensor on the card, as the main path passes it), its plain
    version and SDPA over the cache (no rope, no cache write) timed on
    ``_decode_inputs``' ``args``, beside the least time the card could take."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.fused_decode import fused_decode_attention, fused_decode_plain

    q, kn, vn, cos, sin, kc, vc, start, valid = args
    b, _, h, d = q.shape
    kvh, s = kc.shape[1], kc.shape[2]
    scale = d ** -0.5
    pos_t = torch.full((1,), pos, dtype=torch.int32, device="cuda")
    ms = device_ms(lambda: fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos_t, start,
                                                  valid, scale=scale))
    kc2, vc2 = kc.clone(), vc.clone()
    plain_ms = device_ms(lambda: fused_decode_plain(q, kn, vn, cos, sin, kc2, vc2, pos, start,
                                                    valid, scale=scale))
    slots = torch.arange(s, device="cuda")[None, :]
    live = ((slots >= start[:, None].long()) & (slots < pos) & (valid != 0)) | (slots == pos)
    qt, m4 = q.transpose(1, 2), live[:, None, None, :]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=m4, scale=scale, enable_gqa=True))
    n_live = int(live.sum()) - b  # cache slots read; the new column comes in registers
    nbytes = (n_live * kvh * d * 2 * 2                      # K and V of live slots
              + (q.numel() * 2 + kn.numel() + vn.numel() + cos.numel() + sin.numel()) * 2
              + 2 * b * kvh * d * 2                         # cache write at slot pos
              + valid.numel() * 4 + start.numel() * 4)     # q and out; the rest of the inputs
    bms, by = bound_ms(nbytes, 4.0 * d * h * (n_live + b))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


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
        timed = decode_timed(args, pos)
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
                      max_abs_err=err, **timed, split_slots=SPLIT_SLOTS,
                      ms_pos300_s4096=idle[4096], ms_pos300_s320=idle[320])
        print(f"[decode] B={b} S={s} H={h} KVH={kvh} D={d} pos={pos}: {timed['ms']:.4f} ms "
              f"(split {SPLIT_SLOTS} slots, pos on the card), plain {timed['plain_ms']:.4f} ms, "
              f"sdpa {timed['library_ms']:.4f} ms, bound {timed['bound_ms']:.4f} ms "
              f"({timed['bound_by']}); at pos 300: {idle[4096]:.4f} ms with S = 4096, "
              f"{idle[320]:.4f} ms with S = 320")
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


def paged_timed(q, k_pool, v_pool, tables, ctx, window=None) -> dict:
    """K6 (with its merge), its plain version and SDPA over the same pages
    gathered contiguous beforehand, timed on these inputs, beside the least
    time the card could take."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                            paged_decode_plain)

    n, _, h, d = q.shape
    kvh, bs = k_pool.shape[1], k_pool.shape[2]
    kw = dict(scale=d ** -0.5, sliding_window=window)
    ms = device_ms(lambda: paged_decode_attention(q, k_pool, v_pool, tables, ctx, **kw))
    plain_ms = device_ms(lambda: paged_decode_plain(q, k_pool, v_pool, tables, ctx, **kw))
    s = tables.shape[1] * bs
    kc = k_pool[tables.long()].permute(0, 2, 1, 3, 4).reshape(n, kvh, s, d).contiguous()
    vc = v_pool[tables.long()].permute(0, 2, 1, 3, 4).reshape(n, kvh, s, d).contiguous()
    slots = torch.arange(s, device="cuda")[None, :]
    live = slots < ctx[:, None]
    if window:
        live &= slots >= ctx[:, None] - window
    qt, m4 = q.transpose(1, 2), live[:, None, None, :]
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kc, vc, attn_mask=m4, scale=kw["scale"], enable_gqa=True))
    n_live = int(live.sum())
    nbytes = (n_live * kvh * d * 2 * 2                  # K and V of live slots
              + 2 * q.numel() * 2                       # q and out
              + tables.numel() * 4 + ctx.numel() * 4)
    bms, by = bound_ms(nbytes, 4.0 * d * h * n_live)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=library_ms)


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
    from transformers_tpu_torch.ops.paged_attention import (paged_decode_attention,
                                                            paged_decode_combine,
                                                            paged_decode_merge_plain,
                                                            paged_decode_partials_plain,
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
        timed = paged_timed(q, k_pool, v_pool, tables, ctx)
        # the CB decode loop is host-bound: K6's wrapper costs the host this much a layer
        wrapper_us = host_us(lambda: paged_decode_attention(q, k_pool, v_pool, tables, ctx,
                                                            scale=scale))
        results.append(dict(name="paged_decode", route="cuda",
                            source="transformers_tpu_torch/csrc/paged_decode.cu",
                            replaces="transformers_tpu/ops/pallas/paged_attention.py:216",
                            max_abs_err=err, **timed, split_slots=split, host_us=wrapper_us,
                            library="SDPA over the pages gathered contiguous beforehand"))
        print(f"[paged] N={n} H={h} KVH={kvh} D={d} BS={bs} live slots {sum(lens)}: "
              f"{timed['ms']:.4f} ms (split {split} slots, with the merge kernel), plain "
              f"{timed['plain_ms']:.4f} ms, sdpa (pages pre-gathered) {timed['library_ms']:.4f} "
              f"ms, bound {timed['bound_ms']:.4f} ms ({timed['bound_by']}); the wrapper costs "
              f"the host {wrapper_us:.1f} us a call")

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
    storage types by head_dim 64, 96, 128 and 256 (K7: 64, 128, 256), and
    for the decode kernels by query-head group of up to 4 and up to 8) runs
    at least once. The flash backward runs the forward's cases and those of
    the reference's backward tests, on the kernel forward's output and
    logsumexp."""
    from transformers_tpu_torch.ops.fused_decode import (fused_decode_attention,
                                                         fused_decode_plain)

    worst = {}
    for dtype, tol in TOLERANCE.items():
        for name, (b, sq, skv, h, kvh, d, pads, window, cap) in FLASH_OPS_CASES.items():
            q, k, v, qpos, valid = _flash_inputs(gen, b=b, sq=sq, skv=skv, h=h, kvh=kvh, d=d,
                                                 pads=pads, dtype=dtype)
            kw = dict(scale=d ** -0.5, sliding_window=window, logit_cap=cap)
            err, lse_err, ratio = _flash_errors(q, k, v, qpos, valid, **kw)
            wgmma = dtype != torch.float32 and d == 256
            if err > tol or lse_err > LSE_ATOL or (wgmma and ratio > 1.0):
                raise AssertionError(f"flash kernel disagrees with its plain version: {name} "
                                     f"{dtype}: out {err:.3e} lse {lse_err:.3e} grad_ratio "
                                     f"{ratio:.4f}")
            worst[("flash_fwd", dtype)] = max(worst.get(("flash_fwd", dtype), 0.0), err)
            if wgmma:  # the head_dim-256 route, also against its tiling, twice
                held = _flash_wg_holds(q, k, v, qpos, valid, tol, **kw)
                print(f"[ops cases] flash_fwd wgmma {name} {str(dtype).replace('torch.', '')}: "
                      f"max_abs_err {err:.3e}, lse {lse_err:.3e}, grad_ratio {ratio:.4f}; "
                      f"against the tiled plain version {held['tiled_err']:.3e}, grad_ratio "
                      f"{held['tiled_grad_ratio']:.4f} (tol {tol}, 1); two runs bitwise equal")
        for name, (b, sq, skv, h, kvh, d, pads, window, cap) in {**FLASH_OPS_CASES,
                                                                **FLASH_BWD_CASES}.items():
            q, k, v, qpos, valid = _flash_inputs(gen, b=b, sq=sq, skv=skv, h=h, kvh=kvh, d=d,
                                                 pads=pads, dtype=dtype)
            do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
            wgmma = dtype != torch.float32 and d == 256  # K4/K5's Hopper route: also twice
            errs, ratios = _bwd_errors(q, k, v, qpos, valid, do, twice=wgmma, scale=d ** -0.5,
                                       sliding_window=window, logit_cap=cap)
            del ratios["dv_tensors"]
            if any(r > 1.0 for r in ratios.values()):
                raise AssertionError(f"flash backward kernels disagree with their plain version: "
                                     f"{name} {dtype}: max_abs_err {errs}, ratios {ratios}")
            if wgmma:
                print(f"[ops cases] flash_bwd wgmma {name} {str(dtype).replace('torch.', '')}: "
                      + ", ".join(f"{n} max_abs_err {errs[n]:.3e} grad_ratio {ratios[n]:.4f}"
                                  for n in errs) + " (tol 1); two runs bitwise equal")
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
    n_cases = {"flash_fwd": len(FLASH_OPS_CASES),
               "fused_decode": len(DECODE_OPS_CASES),
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
QUANT_WIDE_ROWS = (24, 32, 64, 100, 128)  # held where ROW_THRESHOLD reaches them
QUANT_SWEEP_ROWS = (1, 2, 4, 8, 16, 32, 64, 128)  # 128: CB's prefill budget
# projections of a Llama-3-8B layer at each shape: q, o; k, v; gate, up; down
QUANT_LAYER_COUNT = {(4096, 4096): 2, (1024, 4096): 2, (14336, 4096): 2, (4096, 14336): 1}
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


def quant_rows() -> tuple:
    """Q1's rows held in phase (b): QUANT_ROWS and the rows above 16 up to
    ROW_THRESHOLD."""
    from transformers_tpu_torch.ops.quantized_linear import ROW_THRESHOLD

    return QUANT_ROWS + tuple(m for m in QUANT_WIDE_ROWS if m <= ROW_THRESHOLD)


def library_q1(x, codes, scale):
    """``torch._weight_int8pack_mm`` on Q1's inputs (int8 codes; its scale in
    x's dtype, rounded): the PyTorch call closest to Q1, a yardstick the port
    never calls. None where the card's torch does not run it."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return None
    try:
        return fn(x, codes, scale.to(x.dtype))
    except (RuntimeError, NotImplementedError):
        return None


def rows_sweep(gen) -> dict:
    """Q1 against Q2's route (widening, then torch.mm) at each shape and row
    count, int8 codes x bf16, each weight read from device memory: the sweep
    that sets ROW_THRESHOLD."""
    from transformers_tpu_torch.ops import quantized_linear as ql

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
    layer = {m: tuple(sum(sweep[f"{n}x{k}"][m][i] * QUANT_LAYER_COUNT[(n, k)]
                          for n, k in QUANT_SHAPES) for i in (0, 1)) for m in QUANT_SWEEP_ROWS}
    print("[quantized] sweep: a layer's seven projections, M: Q1 ms / Q2 route ms: "
          + ", ".join(f"{m}: {a:.4f}/{b:.4f}" for m, (a, b) in layer.items()))
    return sweep


def check_quantized_linear(gen) -> list:
    """Q1 (quantized_matmul) and Q2 (widen_codes, then torch.mm) against the
    plain ``quantized_dot`` for each code type (int8, int4, fp8) and
    activation type (bf16, f16, f32) at the four Llama-3-8B projection shapes
    and ``quant_rows()`` rows (Q2 at QUANT_ROWS and a prefill's 256), plus
    int4 at K = 4104 (8 values past the last whole chunk, rows not a multiple
    of 16 bytes); held element by element to one rounding step
    (``grad_ratio``) and to TOLERANCE below QUANT_ATOL_RANGE, since both sides
    sum in f32 and round once. The tensor-core Q1 (bf16, f16) is held the
    same way to ``quantized_matmul_split_plain`` at its split, and run twice
    (bitwise-equal outputs required). Then a graph of Q2's route replayed
    after Q2's buffer grew, the times at the main shape, and the rows sweep
    that set ROW_THRESHOLD."""
    import torch.nn.functional as F

    from transformers_tpu_torch.ops import quantized_linear as ql
    from transformers_tpu_torch.quantizers.weight_only import (dequantize_int8, quantized_dot,
                                                               unpack_int4_codes)

    def plain(x, codes, scale, k):
        w = unpack_int4_codes(codes) if ql.code_type(codes, k) == "int4" else codes
        return quantized_dot(x, w, scale, x.dtype)

    def hold(label, out, ref, dtype):
        in_range = ref.float().abs() < QUANT_ATOL_RANGE
        err = float((out.float() - ref.float()).abs()[in_range].max())
        ratio = grad_ratio(out, ref, GRAD_ULP[dtype])
        if not (err <= TOLERANCE[dtype] and ratio <= 1.0 and bool(torch.isfinite(out).all())):
            raise AssertionError(f"{label}: max_abs_err {err:.3e} (tol {TOLERANCE[dtype]}) below "
                                 f"|{QUANT_ATOL_RANGE}|, grad_ratio {ratio:.3f} (at most 1)")
        return err, ratio

    worst = {}
    rows = quant_rows()
    cases = [(n, k, m) for n, k in QUANT_SHAPES for m in rows]
    repeats = 0
    for method in ("int8", "int4", "fp8"):
        extra = [(512, 4104, 3), (512, 4104, 16)] if method == "int4" else []
        weights = {}
        for n, k, m in cases + extra:
            if (n, k) not in weights:
                weights[(n, k)] = _quantized_weights(gen, n, k, method)
            codes, scale = weights[(n, k)]
            for dtype in (torch.bfloat16, torch.float16, torch.float32):
                routes = [(m, "q1")]
                if m in QUANT_ROWS:
                    routes.append((m, "q2"))
                if m == QUANT_ROWS[-1]:
                    routes.append((QUANT_PREFILL_ROWS, "q2"))
                for rows_, route in routes:
                    x = torch.randn((rows_, k), generator=gen, device="cuda").to(dtype)
                    ref = plain(x, codes, scale, k)
                    out = (ql.quantized_matmul(x, codes, scale, k) if route == "q1"
                           else ql._widened_matmul(x, codes, scale, k))
                    torch.cuda.synchronize()
                    label = f"{route} {method} {dtype} N={n} K={k} M={rows_}"
                    err, ratio = hold(label, out, ref, dtype)
                    if route == "q1" and dtype != torch.float32:
                        split = ql.split_size(n, k)
                        hold(f"{label} against the split plain version (split {split})", out,
                             ql.quantized_matmul_split_plain(x, codes, scale, k, split), dtype)
                        again = ql.quantized_matmul(x, codes, scale, k)
                        torch.cuda.synchronize()
                        if not torch.equal(out, again):
                            raise AssertionError(f"{label}: two runs of Q1 differ")
                        repeats += 1
                    key = (route, method, str(dtype).replace("torch.", ""))
                    w_err, w_ratio, w_ref = worst.get(key, (0.0, 0.0, 0.0))
                    worst[key] = (max(w_err, err), max(w_ratio, ratio),
                                  max(w_ref, float(ref.float().abs().max())))
        del weights
    for (route, method, dtype), (err, ratio, top) in sorted(worst.items()):
        print(f"[quantized] {route} {method} x {dtype}: max_abs_err {err:.3e} where |plain| < "
              f"{QUANT_ATOL_RANGE} (tol {TOLERANCE[getattr(torch, dtype)]}), worst |err| / "
              f"(u |plain| + u/2 rms) {ratio:.3f} at u = {GRAD_ULP[getattr(torch, dtype)]:.3g} "
              f"(at most 1), largest |plain| {top:.2f}, over N x K in {QUANT_SHAPES}, M in "
              f"{rows if route == 'q1' else QUANT_ROWS} (q2 also {QUANT_PREFILL_ROWS})"
              + (", int4 K=4104" if method == "int4" else ""))
    print(f"[quantized] tensor-core Q1 (bf16, f16) also held to quantized_matmul_split_plain at "
          f"its split and run twice: {repeats} cases, outputs bitwise equal")
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
            linear = device_ms(_cycled(lambda w: F.linear(x, w), dense))
            lib_out = library_q1(x, *codes_list[0])
            lib = None
            if lib_out is not None:
                lib_err = max_err(lib_out, plain(x, *codes_list[0], k))
                lib = device_ms(_cycled(lambda cs: library_q1(x, cs[0], cs[1]), codes_list))
            plain_ms = device_ms(_cycled(lambda cs: plain(x, cs[0], cs[1], k), codes_list))
            deq = device_ms(_cycled(lambda cs: F.linear(x, dequantize_int8(
                cs[0], cs[1], torch.bfloat16)), codes_list))
            nbytes = n * k + n * 4 + m * (k + n) * 2
            bms, by = bound_ms(nbytes, 2.0 * m * n * k)
            row[m] = dict(ms=q1, bound_ms=bms, bound_by=by, library_ms=lib, linear_ms=linear,
                          plain_ms=plain_ms, dequant_linear_ms=deq, split=ql.split_size(n, k))
            print(f"[quantized] Q1 int8 x bf16 N={n} K={k} M={m} (split {ql.split_size(n, k)}): "
                  f"{q1:.4f} ms, bound {bms:.4f} ms ({by}), fraction of bound {bms / q1:.3f}; "
                  + (f"torch._weight_int8pack_mm {lib:.4f} ms (|its out - plain| {lib_err:.3e}, "
                     f"its scale rounded to bf16)" if lib is not None else
                     "torch._weight_int8pack_mm does not run here")
                  + f"; bf16 F.linear {linear:.4f} ms, plain quantized_dot {plain_ms:.4f} ms, "
                  f"dequantize then F.linear {deq:.4f} ms")
        by_shape[f"{n}x{k}"] = row
        del codes_list, dense

    sweep = rows_sweep(gen)

    n, k = QUANT_MAIN_SHAPE
    main = by_shape[f"{n}x{k}"][QUANT_MAIN_ROWS]
    lib_note = ("library_ms: torch._weight_int8pack_mm (int8 codes, its scale rounded to "
                "bf16) at the same shape" if main["library_ms"] is not None else
                "library_ms: none (torch._weight_int8pack_mm does not run on this card's "
                "torch)")
    q1_entry = dict(name="quantized_matmul", route="cuda",
                    source="transformers_tpu_torch/csrc/quantized_linear.cu",
                    replaces="transformers_tpu/quantizers/weight_only.py:104 (quantized_dot, no "
                             "pallas_call: XLA fuses the widening into the dot)",
                    max_abs_err=max(e for (r, *_), (e, *_) in worst.items() if r == "q1"),
                    ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"], library_ms=main["library_ms"],
                    linear_ms=main["linear_ms"],
                    shape=f"int8 x bf16, N={n} K={k} M={QUANT_MAIN_ROWS}",
                    note=lib_note + "; linear_ms: bf16 F.linear at the same shape",
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


def check_load_path(seed: int, card: str, model_type: str = "llama",
                    geometry: dict = GEOMETRY) -> None:
    """Full width, depth cut to 2 layers: save with the port's safetensors
    writer, read back with ``AutoModelForCausalLM.from_pretrained``, and hold
    the weights and logits to the model that was saved. A model with tied
    embeddings writes no ``lm_head``; the file's keys are the checkpoint's
    (``checkpoint_state_dict``: a mixture-of-experts model's stacked experts
    one tensor per expert)."""
    from transformers_tpu_torch import AutoConfig, AutoModelForCausalLM
    from transformers_tpu_torch.core.loading import checkpoint_state_dict, resolve_checkpoint_files
    from transformers_tpu_torch.core.safetensors import SafetensorsFile
    from transformers_tpu_torch.ops import cuda_build

    cfg = AutoConfig.for_model_type(model_type, **dict(geometry, num_hidden_layers=2),
                                    dtype="bfloat16")
    model = AutoModelForCausalLM.from_config(cfg, dtype=torch.bfloat16,
                                             device="cuda").init_weights(seed)
    ckpt = cuda_build.BUILD_DIR / "smoke_checkpoint"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        save_ms = _timed(lambda: model.save_pretrained(ckpt))
        size = sum(f.stat().st_size for f in ckpt.iterdir())
        keys = set()
        for path in resolve_checkpoint_files(str(ckpt)):  # shards above 5 GiB
            with SafetensorsFile(path) as f:
                keys |= set(f.keys())
        has_head = "lm_head.weight" in keys
        holder = {}
        load_ms = _timed(lambda: holder.update(m=AutoModelForCausalLM.from_pretrained(ckpt)))
        loaded = holder["m"]
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if has_head == cfg.tie_word_embeddings:
        raise AssertionError(f"lm_head in the file: {has_head}, tied embeddings: "
                             f"{cfg.tie_word_embeddings}")
    if keys != set(checkpoint_state_dict(model)):
        raise AssertionError(f"the file's keys are not the checkpoint's: "
                             f"{sorted(keys ^ set(checkpoint_state_dict(model)))[:8]}")
    per_expert = sum(".experts." in k and k.split(".experts.")[1][0].isdigit() for k in keys)
    if type(loaded) is not type(model):
        raise AssertionError(f"from_pretrained built {type(loaded).__name__}")
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
    print(f"[load] {model_type}: 2-layer full-width checkpoint, {size / 1e9:.2f} GB (lm_head "
          f"{'in the file' if has_head else 'absent: tied'}"
          + (f"; {per_expert} per-expert tensors" if per_expert else "")
          + f"): save {save_ms:.0f} ms, from_pretrained {load_ms:.0f} ms; weights and logits "
          f"identical ({card})")


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


def generate_inputs(seed: int, vocab: int, prompt: int = PROMPT, pads=PADS) -> tuple:
    """len(pads) prompts of ``prompt`` tokens from ``seed`` (phase (c)'s by
    default), row r left-padded by pads[r] slots: (ids, mask)."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ids = torch.randint(1, vocab, (len(pads), prompt), generator=gen, device="cuda")
    mask = (torch.arange(prompt, device="cuda")[None, :]
            >= torch.tensor(pads, device="cuda")[:, None]).to(torch.int32)
    return ids.masked_fill(mask == 0, 0), mask


def check_generate(model, seed: int, card: str) -> dict:
    """Phase (c): greedy generate with the decode step replayed from its CUDA
    graph, against the uncaptured step loop (``_generate(graph=False)``) on the
    same inputs: ids bitwise equal, launch counts exact for both; the replays
    run under ``no_host_sync``. Then sampled at one seed (top-k, top-p) and
    greedy with processors, each graph against the step loop, bitwise. The
    calls use ``decode_pad_multiple=NEW``, so the prefill-only runs (1 new
    token) share the 32-token program and nothing is captured twice."""
    ids, mask = generate_inputs(seed, model.config.vocab_size)
    out, counts = generate_graph_vs_loop("generate", model, ids, mask, NEW, card, timed=True)
    graph, eager = _generate_runs(model, ids, mask, NEW)

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
    # device activity only: the host's op events would be most of the trace,
    # and reading them back took over a minute for Gemma-3-12B's runs
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
            f"{name} {e.self_device_time_total / 1e3:.3f} ms x{e.count} "
            f"({e.self_device_time_total / 1e3 / busy_ms:.1%} of busy)" for name, e in ours))
    return kernels


def teacher_force(model, seq, prompt_mask, quant=None, prompt: int = PROMPT,
                  label: str = "teacher-force", release: bool = False,
                  f32_in_place: bool = False) -> None:
    """The generated sequence through the kernel path (prefill of all but the
    last token, then one decode step) and through the plain path (eager
    attention, no cache, no kernel), against the same model in float32 as
    the reference. The kernel path must be no further from float32 than twice
    the plain bf16 path is: both are bf16 through 32 layers, and they round
    at different places (f32 rope in the decode kernel, f32 probabilities in
    both kernels). ``release``, ``f32_in_place``: see ``plain_and_f32_logits``."""
    b, total = seq.shape
    mask = torch.cat([prompt_mask, torch.ones((b, total - prompt), dtype=torch.int32,
                                              device="cuda")], dim=1)
    pos = (mask.cumsum(-1) - 1).clamp_min(0)
    with torch.inference_mode():
        cache = model.init_cache(b, total)
        model(seq[:, :-1], attention_mask=mask, position_ids=pos[:, :-1], past_key_values=cache,
              cache_position=0, logits_to_keep=1)
        kernel = model(seq[:, -1:], attention_mask=mask, position_ids=pos[:, -1:],
                       past_key_values=cache, cache_position=total - 1).logits[:, -1].float()
        del cache
    [(plain_all, ref)] = plain_and_f32_logits(model, [(seq, mask, pos)], quant, release=release,
                                              f32_in_place=f32_in_place)
    plain = plain_all[:, -1].float()
    agree = float((plain_all[:, prompt - 1:-1].argmax(-1) == seq[:, prompt:]).float().mean())
    hold_to_plain(label, kernel, plain, ref,
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


@contextlib.contextmanager
def computing_in(model, dtype):
    """Every module of ``model`` computes in ``dtype`` (each module's
    ``dtype``), its weights widened at each call: the float32 run of a model
    whose float32 copy would not fit on the card beside it."""
    saved = [(m, m.dtype) for m in model.modules()
             if isinstance(getattr(m, "dtype", None), torch.dtype)]
    for m, _ in saved:
        m.dtype = dtype
    try:
        yield
    finally:
        for m, d in saved:
            m.dtype = d


def plain_and_f32_logits(model, batches, quant=None, all_positions: bool = False,
                         release: bool = False, f32_in_place: bool = False) -> list:
    """For each (ids, mask, positions) batch: the logits of every position
    through the plain path (eager attention, no cache, no kernel; quantized
    Linears through the plain ``quantized_dot``) of ``model``, and the last
    position's logits (every position's with ``all_positions``) of the same
    model in float32 (the reference; a model quantized with ``quant`` keeps
    its codes and scales and computes the quantized product in f32). With
    ``release``, for a model too large to sit beside its float32 copy on the
    card: ``model`` moves to the host (its decode program dropped) before the
    copy is built, and the caller frees it. With ``f32_in_place`` the float32
    run is ``model`` itself under ``computing_in(model, float32)``: the same
    bf16 weights, widened at each call, as the copy would hold them."""
    from transformers_tpu_torch import quantize_params

    out = []
    with torch.inference_mode(), plain_quantized():
        _reset_counts()
        model.config.attn_implementation = "eager"
        for ids, mask, pos in batches:
            out.append([model(ids, attention_mask=mask, position_ids=pos).logits])
        model.config.attn_implementation = None
        if any(_read_counts().values()):
            raise AssertionError("the plain path launched a kernel")
        if release:
            model._decode_program = None
            model.to("cpu")
            gc.collect()
            torch.cuda.empty_cache()
        if f32_in_place:
            ref_model, widened = model, computing_in(model, torch.float32)
        else:
            ref_model, widened = (type(model)(model.config, dtype=torch.float32, device="cuda"),
                                  contextlib.nullcontext())
            if quant is not None:
                quantize_params(ref_model, quant)  # the layout; the codes come from ``model``
            ref_model.load_state_dict(model.state_dict())
        ref_model.config.attn_implementation = "eager"
        with widened:
            for item, (ids, mask, pos) in zip(out, batches):
                logits = ref_model(ids, attention_mask=mask, position_ids=pos,
                                   logits_to_keep=0 if all_positions else 1).logits
                item.append(logits if all_positions else logits[:, -1])
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


def cb_engine(model, steps_per_sync: int, graph: bool, settings: dict = CB_ENGINE):
    """A fresh engine with ``settings``; ``graph`` False makes its runner run
    each decode step uncaptured (the reference the graphs are held to)."""
    from transformers_tpu_torch.generation.continuous_batching import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(model, steps_per_sync=steps_per_sync, **settings)
    engine.runner._capture = graph
    return engine


def run_cb(engine, prompts, tag: str, strict: bool = False, new: int = CB_NEW):
    """Serve ``prompts`` (``new`` new tokens each, greedy) through ``engine``.
    Returns the generated ids per request, the wall ms, the host-clock ms and
    device decode steps of the engine steps that ran decode and no prefill
    (each such step ends in a host read), and the runner's counts of this run.
    ``strict``: the runner's decode calls run under ``no_host_sync``."""
    from transformers_tpu_torch.generation.continuous_batching import RequestState

    for i, p in enumerate(prompts):
        engine.add_request(RequestState(request_id=f"{tag}{i}", prompt_ids=p,
                                        max_new_tokens=new))
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


def cb_graph_vs_uncaptured(label: str, model, prompts, steps: int, card: str,
                           new: int = CB_NEW, settings: dict = CB_ENGINE) -> dict:
    """At ``steps`` steps per sync, an engine whose decode steps replay
    captured graphs and one that runs them uncaptured. Each engine first
    serves the prompts shifted by one token id (its graphs are captured and
    cuBLAS warmed there, on the same schedule), then the measured prompts;
    the graph engine's decode calls run under ``no_host_sync``. Tokens of the
    two engines must be equal for every request in both runs, launch counts
    exact (K1 once per layer per prefill chunk, K6 and its merge once per
    layer per decode step). Returns the graph engine's run: its engine,
    generated ids, launch counts, wall ms and ms per device decode step."""
    layers, vocab = model.config.num_hidden_layers, model.config.vocab_size
    runs = {}
    for graph in (True, False):
        name = "graph" if graph else "uncaptured"
        engine = cb_engine(model, steps, graph, settings)
        warm = run_cb(engine, shifted(prompts, vocab, 1), "warm", new=new)[0]
        _reset_counts()
        generated, wall, decode_ms, decode_steps, r = run_cb(engine, prompts, "r",
                                                             strict=graph, new=new)
        counts = _read_counts()
        paged = layers * (r["decode_steps"] + r["single_token_chunks"])
        expected = _expected(flash_fwd=layers * r["prefill_chunks"], paged_decode=paged,
                             paged_decode_combine=paged)
        print(f"[{label}] {name}, steps_per_sync={steps}: launches {counts}, expected "
              f"{expected} ({layers} layers, {r['prefill_chunks']} prefill chunks, "
              f"{r['single_token_chunks']} one-token chunks, {r['decode_steps']} decode steps)")
        if counts != expected:
            raise AssertionError(f"{label}: the CB path did not go through the kernels as "
                                 f"required")
        if any(len(g) != new or min(g) < 0 or max(g) >= vocab for g in generated):
            raise AssertionError(f"{label}: a request did not return {new} ids inside the "
                                 f"vocabulary")
        cached = sum(len(p) for p in prompts) - r["prefill_tokens"]
        step_ms = decode_ms / max(decode_steps, 1)
        print(f"[{label}] {name}, steps_per_sync={steps}: {len(prompts)} requests, prompts "
              f"{min(map(len, prompts))}-{max(map(len, prompts))} tokens ({cached} served from "
              f"the prefix cache), {new} new tokens each, bf16, {layers} layers: wall "
              f"{wall:.2f} ms, {len(prompts) * new * 1e3 / wall:.1f} generated tokens/s, decode "
              f"{step_ms:.3f} ms per device step over {decode_steps} steps of decode-only engine "
              f"steps; {len(engine.runner._programs)} decode programs; warmed first ({card})")
        runs[name] = dict(engine=engine, warm=warm, generated=generated, counts=counts,
                          wall=wall, step_ms=step_ms)
    graph, eager = runs["graph"], runs.pop("uncaptured")
    same = graph["generated"] == eager["generated"] and graph["warm"] == eager["warm"]
    print(f"[{label}] steps_per_sync={steps}: graph engine's tokens == uncaptured engine's for "
          f"every request, in the warm-up (where each graph's first call runs the step for "
          f"real and captures it) and the measured run: {same}")
    if not same:
        raise AssertionError(f"{label}: the graph engine's tokens differ from the uncaptured "
                             f"one's")
    del eager
    gc.collect()
    torch.cuda.empty_cache()
    return graph


def check_cb(model, seed: int, card: str) -> tuple:
    """Phase (d): continuous batching at full width on the 32-layer model, at
    one sync per step and one per 16, each graph engine held to an
    uncaptured one (``cb_graph_vs_uncaptured``). Returns the launches at one
    sync per step and the graph engines' (generated tokens/s, ms per device
    decode step) by steps per sync."""
    prompts = cb_prompts(seed, model.config.vocab_size)
    runs = {steps: cb_graph_vs_uncaptured("cb", model, prompts, steps, card)
            for steps in (1, 16)}
    same = sum(a == b for x, y in zip(runs[1]["generated"], runs[16]["generated"])
               for a, b in zip(x, y))
    print(f"[cb] steps_per_sync 1 vs 16: {same} of {CB_REQUESTS * CB_NEW} generated tokens "
          f"equal (bf16 GEMMs of other batch shapes round differently; random weights give "
          f"near-ties)")
    # the graph engine only, to keep the run well inside its time limit
    engine = runs[16]["engine"]
    profile_run("continuous batching, 16 steps per sync (graph)",
                lambda: run_cb(engine, shifted(prompts, model.config.vocab_size, 2), "prof"),
                runs[16]["wall"], card)
    teacher_force_cb(model, engine, prompts, runs[16]["generated"])
    rates = {steps: (CB_REQUESTS * CB_NEW * 1e3 / r["wall"], r["step_ms"])
             for steps, r in runs.items()}
    return runs[1]["counts"], rates


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


# --------------------------------------------------------------------- (h)
# serving: the repo's tokenizer fixture (48k byte-level BPE, Llama-3 split)
# and phase (d)'s engine behind the port's HTTP server, in this process
SERVE_TOKENIZER = "tests/fixtures/bpe48k"
SERVE_NEW = 64
SERVE_LENGTHS = (90, 500)  # prompt tokens, as phase (d)'s
# (endpoint, streamed) of the 12 requests sent at once
SERVE_REQUESTS = ([("completions", False)] * 2 + [("completions", True)] * 4
                  + [("chat", False)] * 2 + [("chat", True)] * 2
                  + [("responses", False), ("responses", True)])
SERVE_TEXT = """\
The river rises in the hills above the town and runs south for ninety miles before it \
meets the sea. In spring the snow melts and the water climbs the stone banks; by late \
summer it is shallow enough to cross on foot, and the children of the valley do.

def merge_ranges(ranges):
    out = []
    for first, last in sorted(ranges):
        if out and first <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], last))
        else:
            out.append((first, last))
    return out

東京の朝は早い。駅には六時前から人が集まり、電車は数分おきに到着する。北京的秋天很短，\
树叶在十月底就落光了。서울의 지하철은 깨끗하고 빠르다。

Invoice 2024-117: 3 units at 1,250.00 each = 3,750.00; tax 7.5% = 281.25; total \
4,031.25. Order ids 000417, 918273645 and 31415926535 ship on 12/09.
Column\tseparated\t\tvalues\t\t\tand   runs   of    spaces     between      words.


Three blank lines above, two spaces at the end of this line.  
"""


class IntakeGate:
    """Stands in for the CB manager's intake queue: holds the first ``n``
    requests until all are in, then hands them out in ``order`` (prompt ids ->
    rank), so the engine runs generate_batch's schedule (bf16 GEMMs of other
    batch shapes round differently, phase (d)); later requests pass straight
    through."""

    def __init__(self, n: int, order: dict):
        import threading

        self.n, self.order, self.items = n, order, []
        self.open = False
        self.lock = threading.Lock()

    def put(self, req) -> None:
        with self.lock:
            self.items.append(req)
            if not self.open and len(self.items) == self.n:
                self.items.sort(key=lambda r: self.order[tuple(r.prompt_ids)])
                self.open = True

    def get_nowait(self):
        import queue

        with self.lock:
            if not self.open or not self.items:
                raise queue.Empty
            return self.items.pop(0)


def serve_prompts(tok, seed: int) -> list:
    """len(SERVE_REQUESTS) texts cut from SERVE_TEXT (repeated) to 90-500
    tokens of the port's tokenizer, at offsets and lengths from ``seed``."""
    ids = tok.encode(SERVE_TEXT * 12)
    rng = np.random.default_rng(seed + 7)
    texts = []
    for _ in SERVE_REQUESTS:
        n = int(rng.integers(SERVE_LENGTHS[0], SERVE_LENGTHS[1] + 1))
        start = int(rng.integers(0, len(ids) - n))
        texts.append(tok.decode(ids[start:start + n]))
    return texts


def _serve_body(kind: str, stream: bool, text: str, new: int) -> tuple:
    if kind == "completions":
        return "/v1/completions", {"prompt": text, "max_tokens": new, "temperature": 0,
                                   "stream": stream, "stream_options": {"include_usage": True}}
    if kind == "chat":
        return "/v1/chat/completions", {"messages": [{"role": "user", "content": text}],
                                        "max_tokens": new, "temperature": 0, "stream": stream,
                                        "stream_options": {"include_usage": True}}
    return "/v1/responses", {"input": text, "max_output_tokens": new, "temperature": 0,
                             "stream": stream}


def serve_call(url: str, kind: str, stream: bool, text: str, new: int) -> dict:
    """One request through urllib: its text, usage, deltas and the client's
    clock (sent, each delta's arrival, done)."""
    import urllib.request

    route, body = _serve_body(kind, stream, text, new)
    req = urllib.request.Request(url + route, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    out = {"kind": kind, "stream": stream, "sent": time.perf_counter(), "deltas": [],
           "at": []}
    with urllib.request.urlopen(req, timeout=600) as resp:
        if not stream:
            obj = json.loads(resp.read())
            if kind == "responses":
                out["text"] = obj["output"][0]["content"][0]["text"]
                out["usage"] = (obj["usage"]["input_tokens"], obj["usage"]["output_tokens"])
            else:
                c = obj["choices"][0]
                out["text"] = c["text"] if kind == "completions" else c["message"]["content"]
                out["usage"] = (obj["usage"]["prompt_tokens"], obj["usage"]["completion_tokens"])
        else:
            for raw in resp:
                line = raw.decode().rstrip("\n")
                if not line.startswith("data: ") or line == "data: [DONE]":
                    continue
                ev = json.loads(line[6:])
                if kind == "responses":
                    if ev["type"] == "response.output_text.delta":
                        out["deltas"].append(ev["delta"])
                        out["at"].append(time.perf_counter())
                    elif ev["type"] == "response.completed":
                        r = ev["response"]
                        out["text"] = r["output"][0]["content"][0]["text"]
                        out["usage"] = (r["usage"]["input_tokens"], r["usage"]["output_tokens"])
                elif ev["choices"]:
                    c = ev["choices"][0]
                    d = c["text"] if kind == "completions" else c["delta"].get("content", "")
                    if d:
                        out["deltas"].append(d)
                        out["at"].append(time.perf_counter())
                else:
                    out["usage"] = (ev["usage"]["prompt_tokens"], ev["usage"]["completion_tokens"])
            if kind != "responses":
                out["text"] = "".join(out["deltas"])
    out["done"] = time.perf_counter()
    return out


def check_cancel_on_close(url: str, engine, tok, card: str) -> None:
    """A streamed request (400 new tokens) whose client closes after its 4th
    delta: the manager must report it cancelled and the pages come back."""
    import http.client

    cb = engine.manager.engine
    free = cb.bm.num_free_blocks
    host, port = url.split("//")[1].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=60)
    conn.request("POST", "/v1/completions", headers={"Content-Type": "application/json"},
                 body=json.dumps({"prompt": SERVE_TEXT[:400], "max_tokens": 400,
                                  "temperature": 0, "stream": True}))
    resp = conn.getresponse()
    deltas, rid = 0, None
    while deltas < 4:
        line = resp.fp.readline().decode()
        if not line:
            raise AssertionError("phase (h): the stream ended before its 4th delta")
        if line.startswith("data: {"):
            ev = json.loads(line[6:])
            rid = ev["id"]
            deltas += bool(ev["choices"][0]["text"])
    closed = time.perf_counter()
    resp.close()
    conn.close()
    while time.perf_counter() - closed < 10:
        if (rid in engine.manager.cancelled and not cb.scheduler.active
                and not cb.scheduler.waiting and cb.bm.num_free_blocks == free):
            break
        time.sleep(0.01)
    took = time.perf_counter() - closed
    ok = rid in engine.manager.cancelled and cb.bm.num_free_blocks == free
    print(f"[serve] stream closed after its 4th delta: cancelled by the manager {ok} after "
          f"{took * 1e3:.1f} ms, free pages {cb.bm.num_free_blocks} of {free} before ({card})")
    if not ok:
        raise AssertionError("phase (h): a closed stream was not cancelled, or kept its pages")


def encode_rates(card: str) -> None:
    """The tokenizer's encode rate on the host: the C++ BPE against the plain
    Python merge loop, each from an empty word cache, on the same text (SERVE_TEXT
    and the port's Python sources, 200,000 characters); and how much of it the
    pre-tokenizer's split takes."""
    from pathlib import Path

    import transformers_tpu_torch
    from transformers_tpu_torch.tokenization import TokenizerEngine

    root = Path(transformers_tpu_torch.__file__).parent
    text = (SERVE_TEXT + "".join(p.read_text() for p in sorted(root.rglob("*.py"))))[:200_000]
    rates, ids = {}, {}
    for route, native_bpe in (("C++ BPE", True), ("Python merge", False)):
        eng = TokenizerEngine.from_file(f"{SERVE_TOKENIZER}/tokenizer.json", native_bpe=native_bpe)
        eng.encode("warm up: build and load the merge table")
        eng.model._cache.clear()
        t0 = time.perf_counter()
        ids[route] = eng.encode(text)["input_ids"]
        rates[route] = len(ids[route]) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    words = eng.pre_tokenizer.pre_tokenize(text)
    split_s = time.perf_counter() - t0
    if ids["C++ BPE"] != ids["Python merge"]:
        raise AssertionError("phase (h): the C++ BPE and the Python merge loop disagree")
    n = len(ids["C++ BPE"])
    print(f"[serve] tokenizer encode on the host ({len(text)} chars, {n} tokens, {len(words)} "
          f"words of which {len(set(words))} distinct; ids equal): C++ BPE "
          f"{rates['C++ BPE']:.0f} tokens/s, plain Python merge {rates['Python merge']:.0f} "
          f"tokens/s; the pre-tokenizer's split takes {split_s * 1e3:.1f} ms of the C++ route's "
          f"{n / rates['C++ BPE'] * 1e3:.1f} ms (host CPU beside {card})")


def check_serving(model, seed: int, card: str) -> dict:
    """Phase (h): the OpenAI-compatible server over continuous batching on
    phase (d)'s model. generate_batch first gives the expected ids; then 12
    requests (6 completions, 4 chats, 2 responses; 7 streamed) are sent at
    once from client threads, their texts and usage held to the expected,
    each stream's deltas to the whole text, the launches to the engine's
    counts; then a stream closed early must be cancelled. Returns the served
    run's launch counts."""
    import threading
    import urllib.request

    from transformers_tpu_torch import AutoTokenizer
    from transformers_tpu_torch.cli.serving import OpenAIServer, ServeEngine

    layers = model.config.num_hidden_layers
    engine_kw = dict(CB_ENGINE, steps_per_sync=16)
    tok = AutoTokenizer.from_pretrained(SERVE_TOKENIZER)
    texts = serve_prompts(tok, seed)
    engine = ServeEngine(model, tok, model_name="llama-3-8b-geometry", **engine_kw)
    server = OpenAIServer(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        prompts = [tok.encode(t) if kind == "completions"
                   else engine.chat_prompt_ids([{"role": "user", "content": t}])
                   for t, (kind, _) in zip(texts, SERVE_REQUESTS)]
        # the second call is timed: each builds a fresh engine and captures its
        # graphs, as the server's engine does, and it finds cuBLAS warm
        expected = model.generate_batch(prompts, max_new_tokens=SERVE_NEW, **engine_kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = model.generate_batch(prompts, max_new_tokens=SERVE_NEW, **engine_kw)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        if any(len(g) != SERVE_NEW for g in expected) or again != expected:
            raise AssertionError("phase (h): generate_batch did not return the same 64 ids a "
                                 "prompt twice")
        with urllib.request.urlopen(server.url + "/health", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(server.url + "/v1/models", timeout=60) as r:
            models = [m["id"] for m in json.loads(r.read())["data"]]
        if health != {"status": "ok"} or models != ["llama-3-8b-geometry"]:
            raise AssertionError(f"phase (h): /health {health}, /v1/models {models}")

        engine.manager._in = IntakeGate(len(prompts), {tuple(p): i for i, p in enumerate(prompts)})
        cb = engine.manager.engine
        steps = {"n": 0, "in": 0.0, "first": None, "last": None}
        step = cb.step

        def timed_step():
            # the host clock inside the manager's engine steps: the same steps
            # as generate_batch's, which are all its loop does
            t = time.perf_counter()
            try:
                return step()
            finally:
                steps["last"] = time.perf_counter()
                steps["first"] = steps["first"] or t
                steps["n"] += 1
                steps["in"] += steps["last"] - t

        cb.step = timed_step
        runner = cb.runner
        names = ("prefill_chunks", "single_token_chunks", "decode_steps")
        before = {n: getattr(runner, n) for n in names}
        _reset_counts()
        results = [None] * len(prompts)
        barrier = threading.Barrier(len(prompts))

        def client(i):
            kind, stream = SERVE_REQUESTS[i]
            barrier.wait()
            try:
                results[i] = serve_call(server.url, kind, stream, texts[i], SERVE_NEW)
            except Exception as exc:  # reported below, as a failed request
                results[i] = {"error": repr(exc)}

        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(prompts))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
        torch.cuda.synchronize()
        del cb.step
        counts = _read_counts()
        ran = {n: getattr(runner, n) - before[n] for n in names}
        bad = [i for i, r in enumerate(results) if r is None or "error" in r]
        if bad:
            raise AssertionError(f"phase (h): requests {bad} failed: "
                                 f"{[results[i] for i in bad]}")
        paged = layers * (ran["decode_steps"] + ran["single_token_chunks"])
        want = _expected(flash_fwd=layers * ran["prefill_chunks"], paged_decode=paged,
                         paged_decode_combine=paged)
        print(f"[serve] launches {counts}, expected {want} ({layers} layers, "
              f"{ran['prefill_chunks']} prefill chunks, {ran['single_token_chunks']} one-token "
              f"chunks, {ran['decode_steps']} decode steps)")
        if counts != want:
            raise AssertionError("phase (h): the served path did not go through the kernels "
                                 "as required")
        for i, (r, p, g) in enumerate(zip(results, prompts, expected)):
            text = tok.decode(g, skip_special_tokens=True)
            if r["text"] != text or r["usage"] != (len(p), SERVE_NEW):
                raise AssertionError(
                    f"phase (h): request {i} ({r['kind']}, streamed {r['stream']}) answered "
                    f"{r['text']!r} with usage {r['usage']}; generate_batch gives {text!r}, "
                    f"usage {(len(p), SERVE_NEW)}")
            if r["stream"] and "".join(r["deltas"]) != text:
                raise AssertionError(f"phase (h): request {i}'s deltas do not add up to its text")
        streamed = [r for r in results if r["stream"]]
        if any(len(r["deltas"]) < 2 or r["at"][0] >= r["at"][-1] for r in streamed):
            raise AssertionError("phase (h): a stream arrived in one piece at its end")
        first = min(r["sent"] for r in results)
        wall = max(r["done"] for r in results) - first
        n_tok = len(prompts) * SERVE_NEW
        ttft = np.array([r["at"][0] - r["sent"] for r in streamed]) * 1e3
        gaps = np.concatenate([np.diff(r["at"]) for r in streamed]) * 1e3
        print(f"[serve] {len(prompts)} requests at once (6 completions, 4 chats, 2 responses; "
              f"{len(streamed)} streamed), prompts {min(map(len, prompts))}-"
              f"{max(map(len, prompts))} tokens, {SERVE_NEW} new each, greedy, bf16, {layers} "
              f"layers: every text and usage == generate_batch's, every stream's deltas == its "
              f"text ({card})")
        print(f"[serve] served {n_tok / wall:.1f} generated tokens/s (wall "
              f"{wall * 1e3:.1f} ms from the first request sent to the last answer) against "
              f"generate_batch {n_tok / batch_s:.1f} tokens/s ({batch_s * 1e3:.1f} ms) on the "
              f"same prompt ids and engine settings; time to first delta p50 "
              f"{np.percentile(ttft, 50):.1f} ms, p90 {np.percentile(ttft, 90):.1f} ms; between "
              f"deltas p50 {np.percentile(gaps, 50):.1f} ms (a delta carries up to 16 tokens: "
              f"one host sync per 16 decode steps) ({card})")
        span = steps["last"] - steps["first"]
        print(f"[serve] the manager ran the burst in {steps['n']} engine steps over {span * 1e3:.1f} "
              f"ms: {steps['in'] * 1e3:.1f} ms inside them ({steps['in'] * 1e3 / steps['n']:.2f} ms "
              f"a step), {(span - steps['in']) * 1e3:.1f} ms between them; generate_batch's loop "
              f"runs the same steps in {batch_s * 1e3:.1f} ms ({batch_s * 1e3 / steps['n']:.2f} ms "
              f"a step); the other {len(prompts) * 2} threads of this interpreter (12 clients, 12 "
              f"handlers) share its GIL with the manager ({card})")
        check_cancel_on_close(server.url, engine, tok, card)
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
        thread.join(timeout=30)
    encode_rates(card)
    return counts


# --------------------------------------------------------------------- (g)
# generation routes: beam search on phase (c)'s model; assisted decoding with a
# draft of the Llama-3.2-1B geometry (meta-llama/Llama-3.2-1B config.json)
BEAM_ROWS = (0, 4)  # phase (c)'s prompts with 0 and 40 pad slots
BEAMS, BEAM_RETURN = 4, 2
SMALL_LAYERS = 4  # the float32 holds: the card against the CPU, assisted against greedy
SMALL_BEAM_NEW = 8  # the CPU runs the 4-layer full-width model: few steps
ASSIST_NEW, ASSIST_GAMMA, LOOKUP_TOKENS, SMALL_ASSIST_NEW = 64, 5, 10, 32
DRAFT_GEOMETRY = dict(vocab_size=128256, hidden_size=2048, intermediate_size=8192,
                      num_hidden_layers=16, num_attention_heads=32, num_key_value_heads=8,
                      head_dim=64, tie_word_embeddings=True, rms_norm_eps=1e-5,
                      rope_theta=500000.0, max_position_embeddings=131072,
                      rope_scaling={"rope_type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                                    "high_freq_factor": 4.0,
                                    "original_max_position_embeddings": 8192})


def build_decoder(geometry: dict, layers: int, dtype, seed: int, device="cuda",
                  model_type: str = "llama", param_dtype=None):
    """A ``model_type`` model of ``geometry`` cut to ``layers``, random weights
    from ``seed`` (uninitialised on the CPU: a CPU copy takes the card model's
    weights); ``param_dtype``: the weights' type where it is not ``dtype``."""
    from transformers_tpu_torch import AutoConfig, AutoModelForCausalLM

    cfg = AutoConfig.for_model_type(model_type, **{
        "max_position_embeddings": PROMPT + ASSIST_NEW, **geometry, "num_hidden_layers": layers},
        bos_token_id=None, eos_token_id=None, pad_token_id=0)
    model = AutoModelForCausalLM.from_config(cfg, dtype=dtype, device=device,
                                             param_dtype=param_dtype)
    return model.init_weights(seed) if device == "cuda" else model


def beam_fn(model, new: int, eos=(), early_stopping=False, graph=None):
    from transformers_tpu_torch.generation.beam_search import build_beam_search_fn

    return build_beam_search_fn(model, bucket=PROMPT, total_len=PROMPT + new, max_new=new,
                                num_beams=BEAMS, eos_ids=tuple(eos), pad_id=0,
                                length_penalty=1.0, early_stopping=early_stopping,
                                num_return_sequences=BEAM_RETURN, graph=graph)


def beam_lengths(seqs, eos, t_end: int) -> torch.Tensor:
    """Generated tokens of each returned hypothesis [B * R]: through its first
    EOS, else the search's final length ``t_end`` (a running beam)."""
    gen = seqs.reshape(-1, seqs.shape[-1])[:, PROMPT:]
    hit = torch.isin(gen, torch.tensor(list(eos) or [-1], device=gen.device))
    return torch.where(hit.any(1), hit.int().argmax(1) + 1, t_end)


def teacher_forced_scores(logits, flat, lengths) -> tuple:
    """(length-normalized sums of the generated tokens' log-probabilities [N],
    those log-probabilities [N, NEW], 0 past each row's length)."""
    new = flat.shape[1] - PROMPT
    logp = torch.log_softmax(logits[:, PROMPT - 1:-1].float(), dim=-1)
    tok = logp.gather(-1, flat[:, PROMPT:, None])[..., 0]
    live = torch.arange(new, device=flat.device)[None, :] < lengths[:, None]
    tok = torch.where(live, tok, 0.0)
    return tok.sum(1) / lengths.float(), tok


def hold_beam_scores(model, runs, mask) -> None:
    """The returned scores (length penalty 1.0) against the returned sequences
    teacher-forced through the plain bf16 path and the same model in float32:
    |beam - f32| must be at most twice the plain path's own distance from
    float32, summed over the generated tokens (sum |plain - f32| / n per
    row). A search that reordered the wrong cache rows scores its tokens
    against another beam's context: off by whole units of log-probability."""
    batches, meta = [], []
    for label, seqs, scores, lengths in runs:
        flat = seqs.reshape(-1, seqs.shape[-1])
        full = torch.cat([mask.repeat_interleave(BEAM_RETURN, 0),
                          (torch.arange(flat.shape[1] - PROMPT, device="cuda")[None, :]
                           < lengths[:, None]).to(torch.int32)], dim=1)
        batches.append((flat, full, (full.cumsum(-1) - 1).clamp_min(0)))
        meta.append((label, flat, scores.reshape(-1), lengths))
    for (plain, ref), (label, flat, scores, lengths) in zip(
            plain_and_f32_logits(model, batches, all_positions=True), meta):
        plain_s, plain_tok = teacher_forced_scores(plain, flat, lengths)
        ref_s, ref_tok = teacher_forced_scores(ref, flat, lengths)
        err_beam = float((scores - ref_s).abs().max())
        err_plain = float((plain_s - ref_s).abs().max())
        bound = float(((plain_tok - ref_tok).abs().sum(1) / lengths.float()).max())
        print(f"[beam] {label}: scores {[round(float(x), 5) for x in scores]}, teacher-forced "
              f"f32 {[round(float(x), 5) for x in ref_s]}; |beam - f32| {err_beam:.5f}, |plain - "
              f"f32| {err_plain:.5f}, plain's summed per-token distance {bound:.5f} (the hold: "
              f"|beam - f32| <= 2x that)")
        if not bool(torch.isfinite(scores).all()) or err_beam > 2 * bound:
            raise AssertionError(f"beam search {label}: scores disagree with the teacher-forced "
                                 f"sequences")


def reorder_profile(program, card: str) -> None:
    """Device time of one cache reorder at the program's shape, from the
    profiler over 10 calls, against its bytes (each buffer read and written;
    the gathered copy in between doubles the traffic)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    idx = torch.arange(program.batch * program.num_beams, device="cuda").flip(0)
    with torch.inference_mode():
        program.cache.reorder_(idx)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                program.cache.reorder_(idx)
            torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / 10
    nbytes = sum(t.numel() * t.element_size() for t in program.cache.keys + program.cache.values)
    if busy == 0:
        print("[beam] the profiler recorded no device time: the reorder's device ms not measured")
        return
    print(f"[beam] cache reorder ({program.batch * program.num_beams} rows, {nbytes / 1e9:.4f} GB "
          f"of cache): {busy:.4f} ms of device time per step (profiler, 10 calls; "
          f"{4 * nbytes / busy / 1e6:.0f} GB/s over the 4x bytes a gather and a copy back move) "
          f"({card})")


def check_beam_search(model, seed: int, card: str) -> dict:
    """Phase (g), beam search on the 32-layer model: rows BEAM_ROWS of phase (c)'s
    prompts, BEAMS beams (8 cache rows), NEW new tokens, BEAM_RETURN returned,
    length penalty 1.0; a first run with early_stopping False and no EOS, a
    second with early_stopping True and an EOS taken from the first run's
    best beam at step 3. Each: the signature's first call through
    ``generate`` (prefill, one step for real, the capture, replays), then
    the graph path (under ``no_host_sync``) against the uncaptured step loop:
    sequences and scores bitwise, launches exact (K1 once per layer, K2 once
    per layer per step run); then both runs' scores held to the teacher-forced
    sequences. Returns the first graph run's launches."""
    from transformers_tpu_torch.generation.beam_search import BeamSearch

    layers = model.config.num_hidden_layers
    ids, mask = generate_inputs(seed, model.config.vocab_size)
    ids, mask = ids[list(BEAM_ROWS)], mask[list(BEAM_ROWS)]
    total = PROMPT + NEW
    held_runs, counts0, eos = [], None, ()
    for label, stop in (("early_stopping False, no EOS", False), ("early_stopping True", True)):
        if stop:
            eos = (int(held_runs[0][1][0, 0, PROMPT + 3]),)
            label += f", EOS {eos[0]} (the first run's best beam at step 3)"
        gkw = dict(attention_mask=mask, prompt_pad_multiple=PROMPT, max_new_tokens=NEW,
                   num_beams=BEAMS, num_return_sequences=BEAM_RETURN, length_penalty=1.0,
                   early_stopping=stop, eos_token_id=list(eos))
        model._decode_program = None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        alloc0 = torch.cuda.memory_allocated()
        first = model.generate(ids, **gkw)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        program = model._decode_program
        if not isinstance(program, BeamSearch) or first.shape != (2 * BEAM_RETURN, total):
            raise AssertionError(f"beam search {label}: generate took another route")
        held = torch.cuda.memory_allocated() - alloc0 - first.numel() * first.element_size()
        runs = {}
        for name, graph in (("graph", True), ("uncaptured", False)):
            fn = beam_fn(model, NEW, eos, stop, graph=graph)
            _reset_counts()
            if graph:
                with no_host_sync():
                    seqs, scores = fn(ids, mask)
            else:
                seqs, scores = fn(ids, mask)
            torch.cuda.synchronize()
            counts = _read_counts()
            expected = _expected(flash_fwd=layers, fused_decode=layers * program.steps_run)
            if counts != expected:
                raise AssertionError(f"beam search {label} {name}: launches {counts}, expected "
                                     f"{expected}")
            runs[name] = seqs, scores, counts, program.steps_run, int(program.t)
        (seqs, scores, counts, steps, t_end), other = runs["graph"], runs["uncaptured"]
        same = (torch.equal(seqs, other[0]), torch.equal(scores, other[1]),
                (steps, t_end) == other[3:], torch.equal(first, seqs.reshape(-1, total)))
        finished = int(program.has_finished.sum())
        print(f"[beam] {label}: graph == uncaptured step loop (sequences, scores, steps and "
              f"length), generate == the function: {same}; {steps} steps run, the search's "
              f"length {t_end}, {finished} of {2 * BEAMS} finished hypotheses; launches "
              f"{ {k: v for k, v in counts.items() if v} } for both ({layers} layers, 1 prefill "
              f"at {2 * BEAMS} rows)")
        if not all(same) or not torch.equal(seqs[:, :, :PROMPT], ids[:, None].expand_as(
                seqs[:, :, :PROMPT])) or int(seqs.max()) >= model.config.vocab_size:
            raise AssertionError(f"beam search {label}: graph and step loop differ")
        if not stop and steps != NEW:
            raise AssertionError("beam search without EOS stopped early")
        if stop and finished == 0:
            raise AssertionError("beam search: the EOS finished no hypothesis")
        held_runs.append((label, seqs, scores, beam_lengths(seqs, eos, t_end)))
        if stop:
            continue
        counts0 = counts
        cache_bytes = sum(t.numel() * t.element_size()
                          for t in program.cache.keys + program.cache.values)
        with torch.inference_mode():
            prefill = _median_ms(lambda: program.prefill(model, ids, mask))
            whole = _median_ms(lambda: (program.prefill(model, ids, mask),
                                        program.advance(model, NEW, True)))
            eager = _median_ms(lambda: (program.prefill(model, ids, mask),
                                        program.advance(model, NEW, False)))
        print(f"[beam] graph: B={len(BEAM_ROWS)} x {BEAMS} beams, prompt {PROMPT}, {NEW} new, "
              f"bf16, {layers} layers: prefill {prefill:.2f} ms, {(whole - prefill) / NEW:.3f} "
              f"ms per beam step (replayed; uncaptured {(eager - prefill) / NEW:.3f}), capture "
              f"{program.graph.capture_ms:.2f} ms (host clock); the program holds "
              f"{held / 1e9:.4f} GB (KV cache {cache_bytes / 1e9:.4f} GB, logprobs "
              f"{program.logprobs.numel() * 4 / 1e6:.2f} MB) (medians of 3) ({card})")
        profile_run("beam search (graph)", lambda: beam_fn(model, NEW, graph=True)(ids, mask),
                    whole, card)
        reorder_profile(program, card)
    hold_beam_scores(model, held_runs, mask)
    return counts0


def check_beam_card_vs_cpu(seed: int, card: str):
    """SMALL_LAYERS of the same width in float32: the card's beam search (graph)
    against the port's CPU run of the same weights, SMALL_BEAM_NEW new tokens:
    sequences equal, scores within 1e-4. Returns the card model."""
    small = build_decoder(GEOMETRY, SMALL_LAYERS, torch.float32, seed)
    ids, mask = generate_inputs(seed, small.config.vocab_size)
    ids, mask = ids[list(BEAM_ROWS)], mask[list(BEAM_ROWS)]
    card_seqs, card_scores = beam_fn(small, SMALL_BEAM_NEW)(ids, mask)
    cpu = build_decoder(GEOMETRY, SMALL_LAYERS, torch.float32, seed, device="cpu")
    cpu.load_state_dict(small.state_dict())
    t0 = time.perf_counter()
    cpu_seqs, cpu_scores = beam_fn(cpu, SMALL_BEAM_NEW)(ids.cpu(), mask.cpu())
    cpu_s = time.perf_counter() - t0
    del cpu
    gc.collect()
    err = float((card_scores.cpu() - cpu_scores).abs().max())
    same = torch.equal(card_seqs.cpu(), cpu_seqs)
    print(f"[beam] {SMALL_LAYERS} layers, float32, {SMALL_BEAM_NEW} new: the card's sequences == "
          f"the CPU's: {same}; max |score card - CPU| {err:.2e} (<= 1e-4); CPU run "
          f"{cpu_s:.1f} s ({card})")
    if not same or err > 1e-4:
        raise AssertionError("beam search: the card's result differs from the CPU's")
    return small


class ForwardRoutes:
    """Counts each model's forwards by the attention route they take: the
    static prefill (cache position 0, more than one token: K1), one token (K2),
    or a wider window at a later slot (the unfused cached attention).
    ``models``: role -> model."""

    def __init__(self, models: dict):
        self.models = models
        self.seen = {}
        for role, m in models.items():
            real = m.forward

            def counted(*args, _real=real, _role=role, **kw):
                width = kw["input_ids"].shape[1]
                start = kw.get("cache_position", 0)
                route = ("prefill" if isinstance(start, int) and start == 0 and width > 1
                         else "step" if width == 1 else "window")
                self.seen[f"{_role} {route}"] = self.seen.get(f"{_role} {route}", 0) + 1
                return _real(*args, **kw)

            m.forward = counted

    def expected(self) -> dict:
        flash = fused = 0
        for role, m in self.models.items():
            layers = m.config.num_hidden_layers
            flash += layers * self.seen.get(f"{role} prefill", 0)
            fused += layers * self.seen.get(f"{role} step", 0)
        return _expected(flash_fwd=flash, fused_decode=fused)

    def close(self) -> None:
        for m in self.models.values():
            del m.forward


@contextlib.contextmanager
def acceptance():
    """(accepted, proposed) of every verify round, from the candidate
    generators' ``observe`` hook."""
    from transformers_tpu_torch.generation import candidate_generator

    rounds = []
    base = candidate_generator._CandidateGenerator
    real = base.observe
    base.observe = lambda self, n_accepted, n_proposed: rounds.append((n_accepted, n_proposed))
    try:
        yield rounds
    finally:
        base.observe = real


def assisted_runs(target, draft, prompt, lookup_prompt, new: int, seed: int) -> dict:
    """name: (prompt, generate kwargs) of the assisted runs."""
    return {
        "draft": (prompt, dict(assistant_model=draft, num_assistant_tokens=ASSIST_GAMMA)),
        "prompt lookup": (lookup_prompt, dict(prompt_lookup_num_tokens=LOOKUP_TOKENS)),
        "self-assisted": (prompt, dict(assistant_model=target, num_assistant_tokens=ASSIST_GAMMA)),
        "draft, sampled": (prompt, dict(
            assistant_model=draft, num_assistant_tokens=ASSIST_GAMMA, do_sample=True,
            generator=torch.Generator(device="cuda").manual_seed(seed + 9))),
    }


def check_assisted(model, seed: int, card: str) -> dict:
    """Phase (g), assisted decoding at batch 1 (phase (c)'s first prompt, 128
    tokens; the prompt-lookup run on one whose second 64 tokens repeat its
    first 64), ASSIST_NEW new tokens, target the 32-layer model, draft the
    Llama-3.2-1B geometry (16 layers, head_dim 64, tied embeddings) in bf16:
    launches exact per run (K1 once per layer per prefill, K2 once per layer
    per one-token forward, of the target and the draft), the acceptance rate,
    ms per new token against greedy graph ``generate`` at batch 1 in the same
    call, and the share of tokens equal to greedy (reported: bf16 near-ties
    can flip an argmax between K2 and the unfused verify). Returns the draft
    run's launches."""
    draft = build_decoder(DRAFT_GEOMETRY, DRAFT_GEOMETRY["num_hidden_layers"], torch.bfloat16,
                        seed + 7)
    ids, _ = generate_inputs(seed, model.config.vocab_size)
    prompt = ids[:1]
    lookup = torch.cat([prompt[:, :PROMPT // 2]] * 2, dim=1)
    gkw = dict(prompt_pad_multiple=PROMPT, max_new_tokens=ASSIST_NEW)
    greedy = {id(p): model.generate(p, **gkw) for p in (prompt, lookup)}
    greedy_ms = _median_ms(lambda: model.generate(prompt, **gkw))
    print(f"[assisted] greedy graph generate, batch 1, prompt {PROMPT}, {ASSIST_NEW} new, "
          f"{model.config.num_hidden_layers} layers bf16: {greedy_ms / ASSIST_NEW:.3f} ms per new "
          f"token (median of 3) ({card})")
    counts_draft = None
    for name, (p, kw) in assisted_runs(model, draft, prompt, lookup, ASSIST_NEW, seed).items():
        assistant = kw.get("assistant_model")
        routes = ForwardRoutes({"target": model} if assistant in (None, model)
                               else {"target": model, "draft": assistant})
        _reset_counts()
        try:
            with acceptance() as rounds:
                t0 = time.perf_counter()
                out = model.generate(p, **gkw, **kw)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
        finally:
            routes.close()
        counts, expected = _read_counts(), routes.expected()
        n_new = out.shape[1] - PROMPT
        ref = greedy[id(p)][:, PROMPT:PROMPT + n_new]
        equal = float((out[:, PROMPT:] == ref).float().mean())
        accepted, proposed = sum(a for a, _ in rounds), sum(n for _, n in rounds)
        print(f"[assisted] {name}: {n_new} new tokens in {ms:.1f} ms, {ms / n_new:.3f} ms per new "
              f"token ({ms / n_new / (greedy_ms / ASSIST_NEW):.2f}x greedy graph generate); "
              f"{len(rounds)} rounds, {accepted} of {proposed} proposals accepted "
              f"({accepted / max(proposed, 1):.3f}); {equal:.3f} of the tokens equal greedy "
              f"generate's; forwards by route {routes.seen}; launches "
              f"{ {k: v for k, v in counts.items() if v} } ({card})")
        if counts != expected or n_new != ASSIST_NEW or not torch.equal(out[:, :PROMPT], p) \
                or int(out.max()) >= model.config.vocab_size:
            raise AssertionError(f"assisted {name}: launches {counts}, expected {expected}, or a "
                                 f"malformed output")
        if name == "draft":
            counts_draft = counts
    del draft
    gc.collect()
    torch.cuda.empty_cache()
    return counts_draft


def check_assisted_small(small, seed: int, card: str) -> None:
    """SMALL_LAYERS of each geometry in float32: the draft, prompt-lookup and
    self-assisted outputs equal greedy ``generate``'s bit for bit, and the
    self-assisted run accepts every proposal."""
    draft = build_decoder(DRAFT_GEOMETRY, SMALL_LAYERS, torch.float32, seed + 7)
    ids, _ = generate_inputs(seed, small.config.vocab_size)
    prompt = ids[:1]
    lookup = torch.cat([prompt[:, :PROMPT // 2]] * 2, dim=1)
    gkw = dict(prompt_pad_multiple=PROMPT, max_new_tokens=SMALL_ASSIST_NEW)
    greedy = {id(p): small.generate(p, **gkw) for p in (prompt, lookup)}
    runs = assisted_runs(small, draft, prompt, lookup, SMALL_ASSIST_NEW, seed)
    for name in ("draft", "prompt lookup", "self-assisted"):
        p, kw = runs[name]
        with acceptance() as rounds:
            out = small.generate(p, **gkw, **kw)
        accepted, proposed = sum(a for a, _ in rounds), sum(n for _, n in rounds)
        same = torch.equal(out, greedy[id(p)])
        print(f"[assisted] {SMALL_LAYERS} layers, float32, {name}: == greedy generate bit for "
              f"bit: {same}; {accepted} of {proposed} proposals accepted ({card})")
        if not same or (name == "self-assisted" and accepted != proposed):
            raise AssertionError(f"assisted {name}: differs from greedy generate")
    del draft
    gc.collect()
    torch.cuda.empty_cache()


def check_watermark(seed: int, card: str) -> None:
    """The green-list mask at the full vocabulary for 8 previous tokens (up to
    2**32 - 1), SynthID g-values on a [2, 160] sequence, and one SynthID
    processor step over [2, 128256] scores: the card against the CPU."""
    from transformers_tpu_torch.generation.watermarking import (
        SynthIDTextWatermarkLogitsProcessor, WatermarkLogitsProcessor)

    vocab = GEOMETRY["vocab_size"]
    prev = torch.tensor([0, 1, 2, vocab - 1, 2**31 - 1, 2**31, 3_000_000_000, 2**32 - 1])
    green = WatermarkLogitsProcessor(vocab)
    mask_same = torch.equal(green.greenlist_mask(prev.cuda()).cpu(), green.greenlist_mask(prev))
    synthid = dict(ngram_len=5, keys=[654, 400, 836, 123, 340, 443, 597, 160],
                   sampling_table_size=2**16, sampling_table_seed=0, context_history_size=1024)
    gen = torch.Generator().manual_seed(seed + 11)
    ids = torch.randint(0, vocab, (2, 160), generator=gen)
    scores = torch.randn((2, vocab), generator=gen)
    on_card = SynthIDTextWatermarkLogitsProcessor(**synthid, device="cuda")
    on_cpu = SynthIDTextWatermarkLogitsProcessor(**synthid)
    g_same = torch.equal(on_card.compute_g_values(ids.cuda()).cpu(), on_cpu.compute_g_values(ids))
    err = max_err(on_card(ids.cuda(), scores.cuda()).cpu(), on_cpu(ids, scores))
    print(f"[watermark] green-list mask ({len(prev)} previous tokens x {vocab}) card == CPU: "
          f"{mask_same}; SynthID g-values [2, 160] card == CPU: {g_same}; one SynthID step "
          f"over [2, {vocab}]: max |card - CPU| {err:.2e} (<= 1e-5) ({card})")
    if not (mask_same and g_same) or err > 1e-5:
        raise AssertionError("watermarking: the card differs from the CPU")


def check_generation_routes(model, seed: int, card: str) -> tuple:
    """Phase (g): beam search and assisted decoding on phase (c)'s model, their
    float32 holds at SMALL_LAYERS, and watermarking. Returns the beam and
    assisted paths' launches."""
    beam = check_beam_search(model, seed, card)
    assisted = check_assisted(model, seed, card)
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    small = check_beam_card_vs_cpu(seed, card)
    check_assisted_small(small, seed, card)
    del small
    gc.collect()
    torch.cuda.empty_cache()
    check_watermark(seed, card)
    return beam, assisted


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


def _generate_runs(model, ids, mask, new: int = NEW):
    """(graph, eager): ``generate`` on ``ids`` with its decode step replayed
    from the captured graph, and the uncaptured step loop; one program for
    ``new`` tokens, which the prefill-only timing runs share."""
    kw = dict(attention_mask=mask, prompt_pad_multiple=ids.shape[1], decode_pad_multiple=new)

    def graph(**extra):
        return model.generate(ids, **kw, **extra)

    def eager(**extra):
        return model._generate(ids, graph=False, **kw, **extra)

    return graph, eager


def _first_call(model, graph, watch=None, new: int = NEW) -> dict:
    """The signature's first call (prefill, one step for real, the capture,
    replays), with each decode step run under ``watch``; what the program holds
    afterwards."""
    from transformers_tpu_torch.generation.utils import StaticDecode

    model._decode_program = None
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    alloc0, reserved0 = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    step = StaticDecode.step
    if watch is not None:
        def watched(self, *args):
            with watch.watch():
                return step(self, *args)
        StaticDecode.step = watched
    try:
        first = graph(max_new_tokens=new)
    finally:
        StaticDecode.step = step
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() - alloc0 - first.numel() * first.element_size()
    cache_bytes, buf_bytes = _program_bytes(model)
    return dict(first=first, held=held, cache=cache_bytes, bufs=buf_bytes,
                reserved=torch.cuda.memory_reserved() - reserved0,
                capture_ms=model._decode_program.graph.capture_ms,
                replay=dict(model._decode_program.graph.launches))


def _graph_vs_step_loop(label, model, graph, eager, expected, new: int = NEW,
                        **extra) -> tuple:
    """The graph path (under ``no_host_sync``) and the uncaptured step loop on
    the same inputs: ids bitwise equal, launch counts exact for both. Returns
    the graph path's ids and its launch counts, read just after its run."""
    runs = {}
    for name, run in (("graph", graph), ("uncaptured", eager)):
        _reset_counts()
        if name == "graph":
            with no_host_sync():
                out = run(max_new_tokens=new, **extra)
        else:
            out = run(max_new_tokens=new, **extra)
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
    print(f"[generate] {label}: graph == uncaptured step loop, bitwise (greedy, the graph's "
          f"replays under set_sync_debug_mode('error')); launches {expected} for both")
    return out, counts


def kernel_layers(model) -> tuple:
    """(layers whose static prefill takes K1, layers whose static decode step
    takes K2, layers whose static decode step takes K1), as the skeleton
    routes them: no kernel takes gpt-oss's sinks (the JAX package sends them
    to its XLA path), and K2 takes, as the JAX package's fused-decode gate,
    no softcap (Gemma-2), no rope table narrower than the head (Laguna's full
    layers, GLM-4.5's partial rotary), no layer without rope (Cohere2's full
    layers), and no family that rotates otherwise (ERNIE-4.5 and Cohere's
    interleaved pairs) or normalizes q/k after rope (HunYuan). Multi-head
    latent attention re-expands its cached latents into per-head keys and
    values and attends through the registry, at the prefill and at every
    decode step: K1 where the values are as wide as the queries and keys
    (Mistral4's 128), the eager attention where they are narrower
    (DeepSeek-V2/V3's 128 against 192), as in the JAX package."""
    from transformers_tpu_torch.models.deepseek_v3.modeling_deepseek_v3 import (
        DeepseekV3Attention)
    from transformers_tpu_torch.models.llama.modeling_llama import LlamaAttention
    from transformers_tpu_torch.ops.flash_attention import KERNEL_HEAD_DIMS

    rope = model.model.compute_rope(torch.zeros((1, 1), dtype=torch.long, device=model.device))
    k1 = k2 = k1_step = 0
    for i, layer in enumerate(model.model.layers):
        attn = layer.self_attn
        if isinstance(attn, DeepseekV3Attention):
            fits = attn.qk_head_dim == attn.v_head_dim and attn.v_head_dim in KERNEL_HEAD_DIMS
            k1 += fits
            k1_step += fits
            continue
        if attn.extra_attn_kwargs().get("sinks") is not None:
            continue
        k1 += 1
        cos = model.model.rope_for_layer(rope, i)[0]
        k2 += (attn.logit_cap is None and cos.shape[-1] == attn.head_dim
               and getattr(attn, "apply_rope", True)
               and type(attn).rope_fn is LlamaAttention.rope_fn
               and type(attn).post_rope_qk is LlamaAttention.post_rope_qk)
    return k1, k2, k1_step


def generate_graph_vs_loop(label: str, model, ids, mask, new: int, card: str,
                           timed: bool = False) -> tuple:
    """Greedy ``generate``, graph against the uncaptured step loop
    (``_graph_vs_step_loop``; K1 once per layer per prefill, K2 once per layer
    per decode step, on the layers ``kernel_layers`` gives), the signature's
    first call equal to both. With ``timed``: prefill ms, decode
    ms/step and tokens/s of both paths in turns, the graph's idle share,
    capture ms and the memory its program holds, and a profile of each path.
    Returns (ids, the graph run's launch counts)."""
    layers, (b, prompt) = model.config.num_hidden_layers, ids.shape
    graph, eager = _generate_runs(model, ids, mask, new)
    first = _first_call(model, graph, new=new)
    k1, k2, k1_step = kernel_layers(model)
    expected = _expected(flash_fwd=k1 + k1_step * (new - 1), fused_decode=k2 * (new - 1))
    out, counts = _graph_vs_step_loop(label, model, graph, eager, expected, new=new)
    if not torch.equal(out, first["first"]) or out.shape != (b, prompt + new) \
            or not torch.equal(out[:, :prompt], ids):
        raise AssertionError(f"{label}: the first call's ids differ, or the prompt changed")
    if not timed:
        return out, counts
    timing = {}
    for name, run in (("graph", graph), ("uncaptured", eager), ("uncaptured", eager),
                      ("graph", graph)):
        prefill = _median_ms(lambda: run(max_new_tokens=1))
        total = _median_ms(lambda: run(max_new_tokens=new))
        timing.setdefault(name, []).append((prefill, total))
    for name, pairs in timing.items():
        prefill = min(p for p, _ in pairs)
        total = min(t for _, t in pairs)
        decode_tok = (total - prefill) / (new - 1)
        timing[name] = total
        print(f"[{label}] {name}: B={b} prompt={prompt} new={new} bf16, {layers} layers: "
              f"prefill {prefill:.2f} ms, decode {decode_tok:.3f} ms/step, "
              f"{b * 1e3 / decode_tok:.1f} decode tokens/s, {b * new * 1e3 / total:.1f} "
              f"tokens/s over the whole generate (best of two medians of 3) ({card})")
    own = first["held"] - first["cache"] - first["bufs"]
    print(f"[{label}] graph: capture {first['capture_ms']:.2f} ms (host clock, the first call of "
          f"the signature); the program holds {first['held'] / 1e9:.4f} GB allocated (KV cache "
          f"{first['cache'] / 1e9:.4f} GB, buffers {first['bufs'] / 1e6:.3f} MB, the graph's own "
          f"{own / 1e6:.3f} MB) and {first['reserved'] / 1e9:.4f} GB reserved ({card})")
    profile_run(f"{label} (graph)", lambda: graph(max_new_tokens=new), timing["graph"], card)
    profile_run(f"{label} (uncaptured step loop)", lambda: eager(max_new_tokens=new),
                timing["uncaptured"], card)
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
    ref_model = type(model)(model.config, dtype=torch.float32, device="cuda")
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


@contextlib.contextmanager
def flash_launches_by_window():
    """Counts the flash kernels' launches (K1, K5, K4) by the window each was
    given (0: none), at their C entry points: {(kernel, window): launches}."""
    from transformers_tpu_torch.ops import cuda_build

    window_arg = {"ttpu_flash_fwd": ("flash_fwd", 15), "ttpu_flash_bwd_dq": ("flash_bwd_dq", 18),
                  "ttpu_flash_bwd_dkv": ("flash_bwd_dkv", 18)}  # the window's argument index
    seen = {}
    real = cuda_build.kernel_fn

    def kernel_fn(name, symbol, argtypes):
        fn = real(name, symbol, argtypes)
        if symbol not in window_arg:
            return fn
        kernel, at = window_arg[symbol]

        def call(*args):
            seen[(kernel, args[at])] = seen.get((kernel, args[at]), 0) + 1
            return fn(*args)
        return call

    cuda_build.kernel_fn = kernel_fn
    try:
        yield seen
    finally:
        cuda_build.kernel_fn = real


def _windows(model) -> list:
    """Each layer's attention window (0: global)."""
    return [layer.self_attn.sliding_window or 0 for layer in model.model.layers]


def _by_window(model, steps: int, fwd_per_step: int = 1) -> dict:
    """The launches by window that ``steps`` training steps should make: K1
    ``fwd_per_step`` times and K5, K4 once per layer a step."""
    out = {}
    for w in _windows(model):
        for kernel, n in (("flash_fwd", fwd_per_step), ("flash_bwd_dq", 1), ("flash_bwd_dkv", 1)):
            out[(kernel, w)] = out.get((kernel, w), 0) + n * steps
    return out


def train_leg(model, seed: int, card: str, tag: str = "[train]") -> dict:
    """Phase (e) on one model (f32 weights, bf16 compute): ``check_train_grads``
    on one row, then ``Trainer.train()`` with AdamW for TRAIN_STEPS steps
    over ``train_rows`` with launch counts exact in all and by window, step
    time, training tokens/s, MFU, peak memory and a profiled step; one step
    with gradient checkpointing (K1 twice a layer); the forward + backward's
    peak with and without it. Returns the steps' launch counts."""
    from transformers_tpu_torch.data import default_data_collator

    cfg = model.config
    layers, steps = cfg.num_hidden_layers, TRAIN_STEPS
    n_params = sum(p.numel() for p in model.parameters())
    non_embedding = sum(p.numel() for n, p in model.named_parameters()
                        if "embed_tokens" not in n)
    # the products' weights: a tied model's output head is the embedding
    matmul_params = non_embedding + (cfg.vocab_size * cfg.hidden_size
                                     if cfg.tie_word_embeddings else 0)
    rows = train_rows(seed, cfg.vocab_size)
    batch = default_data_collator(rows)
    one_row = {k: v[:1].cuda() for k, v in batch.items()}
    check_train_grads(model, one_row)

    # TRAIN_STEPS optimizer steps over the same rows; step 1 warms up
    clock = _step_clock()
    trainer = _trainer(model, rows, clock, max_steps=steps)
    _reset_counts()
    with flash_launches_by_window() as by_window:
        trainer.train()
    torch.cuda.synchronize()
    counts = _read_counts()
    expected = _expected(flash_fwd=layers * steps, flash_bwd_dq=layers * steps,
                         flash_bwd_dkv=layers * steps)
    expected_by_window = _by_window(model, steps)
    losses = [e["loss"] for e in trainer.state.log_history if "loss" in e]
    print(f"{tag} launches {counts}, expected {expected} ({layers} layers, {steps} steps); by "
          f"window {dict(sorted(by_window.items()))}; losses {losses}")
    if counts != expected or by_window != expected_by_window:
        raise AssertionError(f"the training path did not go through the kernels as required: "
                             f"by window {by_window}, expected {expected_by_window}")
    if len(losses) != steps or not all(map(math.isfinite, losses)) or losses[-1] >= losses[0]:
        raise AssertionError(f"train: losses not finite or not falling: {losses}")

    step_ms = float(np.median(clock.ms[1:]))
    positions = TRAIN_ROWS * TRAIN_SEQ  # the card computes the pad too
    tokens = sum(_train_lengths(seed))  # non-pad positions: what a user trains on
    h, d = cfg.num_attention_heads, model.model.layers[0].self_attn.head_dim
    # (row, slot) pairs a causal row sees, under each layer's window
    pairs = sum(sum(min(p + 1, w or TRAIN_SEQ) for p in range(TRAIN_SEQ)) for w in _windows(model))
    attn_flops = 3 * 4 * TRAIN_ROWS * pairs * h * d
    flops = 6 * matmul_params * positions + attn_flops
    mfu = flops / (step_ms / 1e3 * BF16_FLOPS_PER_S)
    print(f"{tag} {n_params / 1e9:.3f}e9 parameters ({non_embedding / 1e9:.3f}e9 non-embedding), "
          f"{TRAIN_ROWS} x {TRAIN_SEQ} tokens (lengths {_train_lengths(seed)}), AdamW, f32 weights, "
          f"bf16 compute: step ms "
          f"{', '.join(f'{x:.2f}' for x in clock.ms)}; median of steps "
          f"2-{steps} {step_ms:.2f} ms, {tokens * 1e3 / step_ms:.1f} training tokens/s "
          f"(non-pad), {positions * 1e3 / step_ms:.1f} positions/s, mfu "
          f"{mfu:.4f} ({flops / 1e12:.2f} TFLOP per step at {BF16_FLOPS_PER_S / 1e12:.0f} "
          f"TFLOP/s); peak memory {max(clock.peak) / 1e9:.2f} GB (step 1: "
          f"{clock.peak[0] / 1e9:.2f} GB) ({card})")
    kernels = profile_run(f"{tag[1:-1]} step", lambda: trainer.training_step([batch]), step_ms,
                          card)
    groups = {"K1 flash_fwd": ("flash_fwd",), "K5 flash_bwd_dq": ("flash_bwd_dq",),
              "K4 flash_bwd_dkv": ("flash_bwd_dkv",), "cuBLAS GEMMs": ("nvjet", "gemm"),
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
    with flash_launches_by_window() as by_window_gc:
        trainer.train()
    torch.cuda.synchronize()
    counts_gc = _read_counts()
    expected_gc = _expected(flash_fwd=2 * layers, flash_bwd_dq=layers, flash_bwd_dkv=layers)
    print(f"{tag} gradient checkpointing, one step: launches {counts_gc}, expected "
          f"{expected_gc}; {clock_gc.ms[0]:.2f} ms, peak memory {clock_gc.peak[0] / 1e9:.2f} "
          f"GB against {clock.peak[0] / 1e9:.2f} GB for the first step without it ({card})")
    if counts_gc != expected_gc or by_window_gc != _by_window(model, 1, fwd_per_step=2):
        raise AssertionError("gradient checkpointing did not go through the kernels as "
                             "required")
    del trainer
    gc.collect()
    # the step's peak is AdamW's; forward + backward alone shows the activations
    peaks = {}
    for enable in (False, True):
        model.gradient_checkpointing_enable(enable)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        model(**{k: v.cuda() for k, v in batch.items()}).loss.backward()
        torch.cuda.synchronize()
        peaks[enable] = (torch.cuda.max_memory_allocated() - base) / 1e9
        model.zero_grad(set_to_none=True)
    print(f"{tag} forward + backward of the {TRAIN_ROWS} x {TRAIN_SEQ} batch, peak above the "
          f"weights: {peaks[False]:.2f} GB without gradient checkpointing, {peaks[True]:.2f} GB "
          f"with it (gradients included) ({card})")
    model.gradient_checkpointing_disable()
    return counts


def check_train(seed: int, card: str) -> dict:
    """Phase (e), first leg: Trainer.train() at the Llama-3-8B width, depth
    cut to 4 layers (1.9e9 parameters: f32 weights, gradients and AdamW's two
    moments take 16 bytes each, ~31 GB; all 32 layers would need ~128 GB)."""
    from transformers_tpu_torch import LlamaConfig, LlamaForCausalLM

    print(f"[train] device memory allocated before the phase {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB, peak so far {torch.cuda.max_memory_allocated() / 1e9:.2f} GB ({card})")
    cfg = LlamaConfig(**dict(GEOMETRY, num_hidden_layers=TRAIN_LAYERS),
                      max_position_embeddings=TRAIN_SEQ, bos_token_id=None, eos_token_id=None,
                      pad_token_id=0)
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, param_dtype=torch.float32,
                             device="cuda").init_weights(seed)
    counts = train_leg(model, seed, card)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def check_train_gemma3(seed: int, card: str) -> dict:
    """Phase (e), second leg: Trainer.train() on Gemma-3-12B's text decoder at
    its full width (hidden 3840, 16 over 8 heads, head_dim 256, the tied
    262208-token vocabulary), depth cut to TRAIN_GEMMA3_LAYERS: five sliding
    layers (window 1024, local rope) and one global, so K4 and K5 run their
    head_dim-256 route with and without the window. 2.35e9 parameters at 16
    bytes each (f32 weights, gradients, AdamW's two moments) take ~37.6 GB;
    all 48 layers (12.2e9) would need ~195 GB. A step peaks at ~75.6 GB (the
    f32 logits of the vocabulary, the moments): the leg allocates from
    expandable segments, since after the other phases the cache's free
    blocks were too broken up for the logits' 8 GiB."""
    pattern, window = GEMMA3_12B["sliding_window_pattern"], GEMMA3_12B["sliding_window"]
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        model = build_decoder(GEMMA3_12B, TRAIN_GEMMA3_LAYERS, torch.bfloat16, seed,
                              model_type="gemma3_text", param_dtype=torch.float32)
        windows = _windows(model)
        print(f"[train gemma3] {TRAIN_GEMMA3_LAYERS} of {GEMMA3_12B['num_hidden_layers']} "
              f"layers, windows {windows}; device memory allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB ({card})")
        # every sliding_window_pattern-th layer global, the rest sliding
        implied = [window if (i + 1) % pattern else 0 for i in range(TRAIN_GEMMA3_LAYERS)]
        if windows != implied:
            raise AssertionError(f"the layers' windows {windows} are not the config's {implied}")
        counts = train_leg(model, seed, card, tag="[train gemma3]")
        del model
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    return counts


# --------------------------------------------------------------------- (i)
# The Llama-skeleton families. Gemma-3-12B's text decoder at full width and
# depth: the text_config of google/gemma-3-12b-it's config.json.
GEMMA3_12B = dict(vocab_size=262208, hidden_size=3840, intermediate_size=15360,
                  num_hidden_layers=48, num_attention_heads=16, num_key_value_heads=8,
                  head_dim=256, query_pre_attn_scalar=256, sliding_window=1024,
                  sliding_window_pattern=6, rope_theta=1_000_000.0,
                  rope_scaling={"rope_type": "linear", "factor": 8.0},
                  rope_local_base_freq=10_000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
                  hidden_activation="gelu_pytorch_tanh", max_position_embeddings=131072)
# static generate: 4 rows of 1536 slots, left-padded so that every row's
# context passes the 1024-slot window; continuous batching: 8 requests
G3_PROMPT, G3_NEW, G3_PADS = 1536, 32, (0, 64, 128, 256)
G3_CB_REQUESTS, G3_CB_NEW, G3_CB_LENS = 8, 32, (1100, 2000)
G3_CB_ENGINE = dict(block_size=32, max_batch=8, token_budget=512, num_blocks=520,
                    max_context=2048)
# its depth cut to 24 of 48 (four periods of five sliding layers and one
# global), which keeps the whole smoke near 1000 s beside phase (m)
G3_LAYERS = 24
# the other families: 4 layers at the published widths of these configs
FAMILY_LAYERS, FAMILY_PROMPT, FAMILY_NEW = 4, 128, 16
FAMILY_PADS = (0, 5, 31, 64)
FAMILY_GEOMETRIES = {  # model_type: (source config, geometry)
    "mistral": ("mistralai/Mistral-7B-v0.1", dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5, rope_theta=10000.0,
        sliding_window=4096, max_position_embeddings=32768, tie_word_embeddings=False)),
    "qwen2": ("Qwen/Qwen2.5-7B", dict(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944, num_hidden_layers=28,
        num_attention_heads=28, num_key_value_heads=4, rms_norm_eps=1e-6,
        rope_theta=1_000_000.0, max_position_embeddings=131072, use_sliding_window=False,
        sliding_window=131072, max_window_layers=28, tie_word_embeddings=False)),
    "qwen3": ("Qwen/Qwen3-8B", dict(
        vocab_size=151936, hidden_size=4096, intermediate_size=12288, num_hidden_layers=36,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-6,
        rope_theta=1_000_000.0, max_position_embeddings=40960, tie_word_embeddings=False)),
    "phi3": ("microsoft/Phi-3-mini-4k-instruct", dict(
        vocab_size=32064, hidden_size=3072, intermediate_size=8192, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32, rms_norm_eps=1e-5, rope_theta=10000.0,
        max_position_embeddings=4096, original_max_position_embeddings=4096,
        sliding_window=2047, tie_word_embeddings=False)),
    "gemma": ("google/gemma-7b", dict(
        vocab_size=256000, hidden_size=3072, intermediate_size=24576, num_hidden_layers=28,
        num_attention_heads=16, num_key_value_heads=16, head_dim=256, rms_norm_eps=1e-6,
        rope_theta=10000.0, hidden_activation="gelu_pytorch_tanh",
        max_position_embeddings=8192, tie_word_embeddings=True)),
    "gemma2": ("google/gemma-2-9b", dict(
        vocab_size=256000, hidden_size=3584, intermediate_size=14336, num_hidden_layers=42,
        num_attention_heads=16, num_key_value_heads=8, head_dim=256, query_pre_attn_scalar=256,
        sliding_window=4096, final_logit_softcapping=30.0, attn_logit_softcapping=50.0,
        rms_norm_eps=1e-6, rope_theta=10000.0, hidden_activation="gelu_pytorch_tanh",
        max_position_embeddings=8192, tie_word_embeddings=True)),
    # the mixture-of-experts families on the skeleton (phase j runs Qwen3-MoE)
    "mixtral": ("mistralai/Mixtral-8x7B-v0.1", dict(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        rope_theta=1_000_000.0, sliding_window=None, num_local_experts=8,
        num_experts_per_tok=2, max_position_embeddings=32768, tie_word_embeddings=False)),
    "qwen2_moe": ("Qwen/Qwen1.5-MoE-A2.7B", dict(
        vocab_size=151936, hidden_size=2048, intermediate_size=5632, num_hidden_layers=24,
        num_attention_heads=16, num_key_value_heads=16, rms_norm_eps=1e-6,
        rope_theta=1_000_000.0, num_experts=60, num_experts_per_tok=4,
        moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
        norm_topk_prob=False, decoder_sparse_step=1, use_sliding_window=False,
        sliding_window=32768, max_window_layers=21, max_position_embeddings=8192,
        tie_word_embeddings=False)),
}
# --------------------------------------------------------------------- (j)
# Qwen3-30B-A3B at full width and depth: Qwen/Qwen3-30B-A3B's config.json
# (48 layers, 32 over 4 heads, head_dim 128; 128 experts of 768, 8 a token,
# renormalized; every layer sparse): 30.53e9 parameters, 61.06 GB in bf16
QWEN3_MOE_SOURCE = "Qwen/Qwen3-30B-A3B"
QWEN3_MOE = dict(vocab_size=151936, hidden_size=2048, intermediate_size=6144,
                 num_hidden_layers=48, num_attention_heads=32, num_key_value_heads=4,
                 head_dim=128, rms_norm_eps=1e-6, rope_theta=1_000_000.0,
                 max_position_embeddings=40960, num_experts=128, num_experts_per_tok=8,
                 moe_intermediate_size=768, norm_topk_prob=True, decoder_sparse_step=1,
                 mlp_only_layers=[], use_sliding_window=False, max_window_layers=48,
                 tie_word_embeddings=False)
# its depth cut to 24 of 48 (30.6 GB), which keeps the whole smoke near
# 1000 s beside phase (m)
QWEN3_MOE_LAYERS = 24
MOE_ROUTES = ("dense", "ragged")
# continuous batching: 8 requests of 90-502 tokens, 32 new each, 16 steps a sync
MOE_CB_REQUESTS, MOE_CB_LENS, MOE_CB_NEW = 8, (90, 502), 32
# phase (b)'s K6 contexts at that traffic (prompt + new tokens)
MOE_CB_CONTEXTS = (96, 140, 233, 310, 377, 420, 488, 534)
# the split of the device time by span: a prefill and MOE_SPLIT_NEW - 1
# uncaptured steps (reading a trace with host events costs ~10 s per 1000 ms)
MOE_SPLIT_NEW = 4
# --------------------------------------------------------------------- (k)
# OLMoE-1B-7B at full width and depth: allenai/OLMoE-1B-7B-0924's config.json
# (16 layers, 16 over 16 heads, head_dim 128; 64 experts of 1024, 8 a token,
# not renormalized; no clip_qkv): 6.92e9 parameters, 13.8 GB in bf16
OLMOE_SOURCE = "allenai/OLMoE-1B-7B-0924"
OLMOE = dict(vocab_size=50304, hidden_size=2048, intermediate_size=1024, num_hidden_layers=16,
             num_attention_heads=16, num_key_value_heads=16, rms_norm_eps=1e-5,
             rope_theta=10000.0, max_position_embeddings=4096, num_experts=64,
             num_experts_per_tok=8, norm_topk_prob=False, clip_qkv=None,
             tie_word_embeddings=False)
# gpt-oss-20b at full width and depth: openai/gpt-oss-20b's config.json (24
# layers alternating window 128 and full, 64 over 8 heads, head_dim 64,
# sinks, attention biases; 32 experts of 2880, 4 a token; yarn factor 32):
# 20.9e9 parameters, 41.8 GB in bf16
GPT_OSS_SOURCE = "openai/gpt-oss-20b"
GPT_OSS = dict(vocab_size=201088, hidden_size=2880, intermediate_size=2880, num_hidden_layers=24,
               num_attention_heads=64, num_key_value_heads=8, head_dim=64, num_local_experts=32,
               num_experts_per_tok=4, sliding_window=128, rope_theta=150000.0,
               rope_scaling={"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                             "beta_slow": 1.0, "truncate": False,
                             "original_max_position_embeddings": 4096},
               rms_norm_eps=1e-5, attention_bias=True, max_position_embeddings=131072,
               tie_word_embeddings=False)
# its depth cut to 8 of 24 (4 sliding, 4 full), which keeps the whole smoke
# near 900 s beside phase (l)
GPT_OSS_LAYERS = 8
# Phi-3.5-MoE and Laguna at 4 layers of their widths, through check_families
MOE_FAMILY_GEOMETRIES = {
    # PhimoeConfig's defaults are microsoft/Phi-3.5-MoE-instruct's widths (16
    # experts of 6400, top 2 by the sparsemixer; 32 over 8 heads); its
    # published LongRoPE factor lists are not in the repo: 64 factors of 1.0,
    # which do the same work (the scaled attention factor included)
    "phimoe": ("microsoft/Phi-3.5-MoE-instruct", dict(
        vocab_size=32064, hidden_size=4096, intermediate_size=6400, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, rms_norm_eps=1e-5,
        num_local_experts=16, num_experts_per_tok=2, max_position_embeddings=131072,
        rope_scaling={"type": "longrope", "original_max_position_embeddings": 4096,
                      "short_factor": [1.0] * 64, "long_factor": [1.0] * 64},
        tie_word_embeddings=False)),
    # LagunaConfig's defaults, as the JAX config cites them; at 4 layers three
    # sliding (window 512) and one full, layer 0 dense
    "laguna": ("LagunaConfig (reference modular_laguna.py:50-181)", dict(
        vocab_size=100352, hidden_size=2048, intermediate_size=8192, num_hidden_layers=40,
        num_attention_heads=48, num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-6,
        sliding_window=512, num_experts=256, num_experts_per_tok=8, moe_intermediate_size=512,
        shared_expert_intermediate_size=512, max_position_embeddings=131072,
        tie_word_embeddings=False)),
}
# --------------------------------------------------------------------- (l)
# ERNIE-4.5-21B-A3B at full width and depth: baidu/ERNIE-4.5-21B-A3B-PT's
# config.json (28 layers, 20 over 4 heads at head_dim 128, layer 0 dense at
# 12288, 27 MoE layers of 64 experts of 1536, top 6, 2 shared experts, tied
# 103424-token vocabulary, interleaved rope at theta 500000): 21.83e9
# parameters, 43.7 GB in bf16
ERNIE_MOE_SOURCE = "baidu/ERNIE-4.5-21B-A3B-PT"
ERNIE_MOE = dict(vocab_size=103424, hidden_size=2560, intermediate_size=12288,
                 num_hidden_layers=28, num_attention_heads=20, num_key_value_heads=4,
                 head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
                 max_position_embeddings=131072, use_bias=False, tie_word_embeddings=True,
                 moe_num_experts=64, moe_k=6, moe_intermediate_size=1536,
                 moe_num_shared_experts=2, moe_layer_start_index=1, moe_layer_end_index=27,
                 moe_layer_interval=1)
# Command-R7B at full width and depth: CohereForAI/c4ai-command-r7b-12-2024's
# config.json (32 layers, every fourth full attention with no rope, the others
# sliding at 4096 with interleaved rope; 32 over 8 heads at head_dim 128;
# logit_scale 0.25; tied 256000-token vocabulary): 8.03e9 parameters
CR7B_SOURCE = "CohereForAI/c4ai-command-r7b-12-2024"
CR7B = dict(vocab_size=256000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=32,
            num_attention_heads=32, num_key_value_heads=8, layer_norm_eps=1e-5,
            rope_theta=50000.0, sliding_window=4096, sliding_window_pattern=4,
            logit_scale=0.25, max_position_embeddings=132096, tie_word_embeddings=True)
# static generate: 2 prompts of 5120 slots left-padded by 0 and 512, 32 new;
# CB: 8 requests of 4600-5100 tokens, 32 new, 16 steps a sync, pages of 32
CR7B_PROMPT, CR7B_NEW, CR7B_PADS = 5120, 32, (0, 512)
CR7B_CB_REQUESTS, CR7B_CB_NEW, CR7B_CB_LENS = 8, 32, (4600, 5100)
CR7B_CB_ENGINE = dict(block_size=32, max_batch=8, token_budget=512, num_blocks=1320,
                      max_context=5152)
# phase (b)'s K6 contexts in that traffic's range (prompt + new tokens)
CR7B_CB_CONTEXTS = (4633, 4702, 4788, 4851, 4906, 4977, 5044, 5131)
# the 4-layer families of this phase, through check_families (ERNIE-4.5-0.3B
# at its full 18 layers: FULL_DEPTH)
BASE_FAMILY_GEOMETRIES = {
    "olmo2": ("allenai/OLMo-2-1124-7B", dict(
        vocab_size=100352, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=32, rms_norm_eps=1e-6,
        rope_theta=500000.0, max_position_embeddings=4096, tie_word_embeddings=False)),
    # MiniMaxM2Config's defaults are the published widths (62 layers, 48 over
    # 8 heads, 256 experts of 1536, top 8): at 4 layers ~29 GB of experts
    "minimax_m2": ("MiniMaxM2Config's defaults (MiniMaxAI/MiniMax-M2)", dict(
        vocab_size=200064, hidden_size=3072, intermediate_size=1536, num_hidden_layers=62,
        num_attention_heads=48, num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-6,
        num_local_experts=256, num_experts_per_tok=8, rope_theta=5_000_000.0,
        max_position_embeddings=196608, tie_word_embeddings=False)),
    # CohereConfig's defaults are Command-R v01's widths (64 heads, no GQA)
    "cohere": ("CohereConfig's defaults (CohereForAI/c4ai-command-r-v01)", dict(
        vocab_size=256000, hidden_size=8192, intermediate_size=22528, num_hidden_layers=40,
        num_attention_heads=64, logit_scale=0.0625, layer_norm_eps=1e-5,
        max_position_embeddings=8192, tie_word_embeddings=True)),
    # Cohere2MoeConfig's defaults: 8 experts of 22528, top 2, every layer sparse,
    # window 4096 on three of each four layers
    "cohere2_moe": ("Cohere2MoeConfig's defaults", dict(
        vocab_size=256000, hidden_size=8192, intermediate_size=22528, num_hidden_layers=40,
        num_attention_heads=64, num_experts=8, num_experts_per_tok=2, sliding_window=4096,
        sliding_window_pattern=4, logit_scale=0.0625, max_position_embeddings=8192,
        tie_word_embeddings=True)),
    "ernie4_5": ("baidu/ERNIE-4.5-0.3B-PT", dict(
        vocab_size=103424, hidden_size=1024, intermediate_size=3072, num_hidden_layers=18,
        num_attention_heads=16, num_key_value_heads=2, head_dim=128, rms_norm_eps=1e-5,
        rope_theta=500000.0, max_position_embeddings=131072, use_bias=False,
        tie_word_embeddings=True)),
    # HunYuanDenseV1Config's defaults (Hunyuan-7B's widths) with the alpha rope
    "hunyuan_v1_dense": ("HunYuanDenseV1Config's defaults, alpha 50 (tencent/Hunyuan-7B)", dict(
        vocab_size=290943, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
        num_attention_heads=32, rms_norm_eps=1e-5, rope_scaling={"type": "dynamic",
                                                                  "alpha": 50.0},
        max_position_embeddings=2048, tie_word_embeddings=False)),
    # 64 experts of 3072, top 8, and one shared MLP of 3072 in every layer
    "hunyuan_v1_moe": ("tencent/Hunyuan-A13B-Instruct", dict(
        vocab_size=128167, hidden_size=4096, intermediate_size=3072, num_hidden_layers=32,
        num_attention_heads=32, num_key_value_heads=8, head_dim=128, rms_norm_eps=1e-5,
        num_experts=64, moe_topk=8, rope_theta=10000.0,
        rope_scaling={"type": "dynamic", "alpha": 1000.0}, max_position_embeddings=32768,
        tie_word_embeddings=False)),
}
FULL_DEPTH = ("ernie4_5",)
# the families' shapes at which phase (b) holds and times K1, K2 and K6
FAMILY_KERNEL_SHAPES = {
    # K1: (b, s, h, kvh, d, left pads, window)
    "flash_fwd": {
        "gemma3_12b_prefill_window_1024": (len(G3_PADS), G3_PROMPT, 16, 8, 256, G3_PADS, 1024),
        "gemma3_12b_prefill_global": (len(G3_PADS), G3_PROMPT, 16, 8, 256, G3_PADS, None),
        "phi3_mini_prefill": (len(FAMILY_PADS), FAMILY_PROMPT, 32, 32, 96, FAMILY_PADS, 2047),
        # a query-head group of 8, which no earlier path ran
        "qwen3_30b_a3b_prefill": (BATCH, PROMPT, 32, 4, 128, PADS, None),
        # phase (k)'s groups of 1 (OLMoE) and 6 (Laguna, at Gemma-3's long
        # prompts, so that its 512-slot window bites)
        "olmoe_1b_7b_prefill": (BATCH, PROMPT, 16, 16, 128, PADS, None),
        "laguna_prefill_window_512": (len(G3_PADS), G3_PROMPT, 48, 8, 128, G3_PADS, 512),
        # phase (l)'s odd group of 5 (ERNIE-4.5-21B-A3B, 20 over 4) and the
        # 4096-slot window over Command-R7B's 5120-slot prompts
        "ernie4_5_21b_a3b_prefill": (BATCH, PROMPT, 20, 4, 128, PADS, None),
        "command_r7b_prefill_window_4096": (len(CR7B_PADS), CR7B_PROMPT, 32, 8, 128, CR7B_PADS,
                                            4096),
        # phase (m): GLM-4.5-Air's group of 12 (96 over 8), the widest yet,
        # and Mistral4's decode step (its values as wide as its queries, so
        # the latent cache's re-expanded history goes through K1 one row at
        # a time: 32 over 32 heads at the 4-layer leg's last step)
        "glm4_5_air_prefill": (BATCH, PROMPT, 96, 8, 128, PADS, None),
        "mistral4_decode_step": (len(FAMILY_PADS), FAMILY_PROMPT + FAMILY_NEW, 32, 32, 128,
                                 FAMILY_PADS, None, 1),
    },
    # K2: (b, h, kvh, d, s, pos, starts, window)
    "fused_decode": {
        "gemma3_12b_decode_window_1024": (len(G3_PADS), 16, 8, 256, G3_PROMPT + G3_NEW,
                                          G3_PROMPT + G3_NEW - 1, G3_PADS, 1024),
        "phi3_mini_decode": (len(FAMILY_PADS), 32, 32, 96, FAMILY_PROMPT + FAMILY_NEW,
                             FAMILY_PROMPT + FAMILY_NEW - 1, FAMILY_PADS, 2047),
        "qwen3_30b_a3b_decode": (BATCH, 32, 4, 128, PROMPT + NEW, PROMPT + NEW - 1, PADS,
                                 None),
        "olmoe_1b_7b_decode": (BATCH, 16, 16, 128, PROMPT + NEW, PROMPT + NEW - 1, PADS, None),
        "laguna_decode_window_512": (len(G3_PADS), 48, 8, 128, G3_PROMPT + G3_NEW,
                                     G3_PROMPT + G3_NEW - 1, G3_PADS, 512),
        # MiniMax-M2's group of 6 with no window (phase l, 4 layers)
        "minimax_m2_decode": (len(FAMILY_PADS), 48, 8, 128, FAMILY_PROMPT + FAMILY_NEW,
                              FAMILY_PROMPT + FAMILY_NEW - 1, FAMILY_PADS, None),
    },
    # K6: (n, h, kvh, d, block size, context lengths (None: drawn in G3_CB_LENS), window)
    "paged_decode": {
        "gemma3_12b_cb_window_1024": (G3_CB_REQUESTS, 16, 8, 256, 32, None, 1024),
        "phi3_mini_cb": (BATCH, 32, 32, 96, 32, (77, 140, 300, 511, 64, 96, 200, 576), 2047),
        "qwen3_30b_a3b_cb": (len(MOE_CB_CONTEXTS), 32, 4, 128, 32, MOE_CB_CONTEXTS, None),
        "olmoe_1b_7b_cb": (len(MOE_CB_CONTEXTS), 16, 16, 128, 32, MOE_CB_CONTEXTS, None),
        "laguna_cb_window_512": (G3_CB_REQUESTS, 48, 8, 128, 32, None, 512),
        "ernie4_5_21b_a3b_cb": (len(MOE_CB_CONTEXTS), 20, 4, 128, 32, MOE_CB_CONTEXTS, None),
        "command_r7b_cb_window_4096": (CR7B_CB_REQUESTS, 32, 8, 128, 32, CR7B_CB_CONTEXTS, 4096),
        "glm4_5_air_cb": (len(MOE_CB_CONTEXTS), 96, 8, 128, 32, MOE_CB_CONTEXTS, None),
    },
}


def _family_hold(kernel: str, err: float, ratio: float) -> None:
    """At the families' long contexts an output is a mean of ~1000 values,
    about as small as KERNEL_ATOL, so a dropped kv tile or split could pass
    the absolute hold: each is held relative to its scale too (``grad_ratio``;
    for K1 on the tensor-core route with its probabilities' spread)."""
    if err > KERNEL_ATOL or ratio > 1.0:
        raise AssertionError(f"{kernel} kernel disagrees with its plain version: max_abs_err "
                             f"{err:.3e}, grad_ratio {ratio:.4f}")


def _flash_at(gen, b, s, h, kvh, d, pads, window, sq=None) -> dict:
    """K1 held to its plain version and timed at one family shape, bf16: ``sq``
    query rows (all ``s`` when None) at the end of ``s`` slots."""
    from transformers_tpu_torch.ops.flash_attention import flash_attention

    sq = sq or s
    q, k, v, qpos, valid = _flash_inputs(gen, b=b, sq=sq, skv=s, h=h, kvh=kvh, d=d, pads=pads)
    err, lse_err, ratio = _flash_errors(q, k, v, qpos, valid, scale=d ** -0.5, is_causal=True,
                                        sliding_window=window)
    _family_hold("flash", err, ratio)
    if lse_err > LSE_ATOL:
        raise AssertionError(f"flash kernel's lse disagrees with its plain version: {lse_err:.3e}")
    held = {} if d != 256 else _flash_wg_holds(q, k, v, qpos, valid, KERNEL_ATOL,
                                               scale=d ** -0.5, sliding_window=window)
    # the wrapper's host cost a call (64 calls stay well inside the launch queue);
    # at head_dim 256 it includes encoding the three tensor maps
    wrapper_us = host_us(lambda: flash_attention(q, k, v, q_positions=qpos, kv_valid=valid,
                                                 scale=d ** -0.5, is_causal=True,
                                                 sliding_window=window), calls=64)
    return dict(max_abs_err=err, grad_ratio=ratio, lse_err=lse_err, **held, host_us=wrapper_us,
                **flash_timed(q, k, v, qpos, valid, window),
                shape=f"B={b} Sq={sq} Skv={s} H={h} KVH={kvh} D={d} window={window}")


def _decode_at(gen, b, h, kvh, d, s, pos, starts, window) -> dict:
    """K2 held to its plain version and timed at one family shape, bf16: the
    window moves each row's first live slot up to pos + 1 - window, as a
    sliding layer's step does."""
    from transformers_tpu_torch.ops.fused_decode import fused_decode_attention, fused_decode_plain

    starts = [max(p, pos + 1 - window) if window else p for p in starts]
    args = _decode_inputs(gen, b=b, h=h, kvh=kvh, d=d, s=s, starts=starts)
    out, kc_k, vc_k = _decode_run(fused_decode_attention, args, pos, d ** -0.5)
    ref, kc_p, vc_p = _decode_run(fused_decode_plain, args, pos, d ** -0.5)
    torch.cuda.synchronize()
    err = max(max_err(out, ref), max_err(kc_k, kc_p), max_err(vc_k, vc_p))
    ratio = grad_ratio(out, ref, GRAD_ULP[out.dtype])
    _family_hold("fused decode", err, ratio)
    return dict(max_abs_err=err, grad_ratio=ratio, **decode_timed(args, pos),
                shape=f"B={b} S={s} H={h} KVH={kvh} D={d} pos={pos} window={window}")


def _paged_at(gen, n, h, kvh, d, bs, ctx_lens, window) -> dict:
    """K6 (with its merge) held to its plain version and timed at one family
    shape, bf16."""
    if ctx_lens is None:
        ctx_lens = torch.randint(G3_CB_LENS[0], G3_CB_LENS[1] + 1, (n,), generator=gen,
                                 device="cuda").tolist()
    q, k_pool, v_pool, tables, ctx = _paged_inputs(gen, n=n, h=h, kvh=kvh, d=d, bs=bs,
                                                   ctx_lens=ctx_lens)
    err, ratio = _paged_error(q, k_pool, v_pool, tables, ctx, window)
    _family_hold("paged decode", err, ratio)
    return dict(max_abs_err=err, grad_ratio=ratio,
                **paged_timed(q, k_pool, v_pool, tables, ctx, window),
                shape=f"N={n} H={h} KVH={kvh} D={d} BS={bs} window={window} ctx {ctx_lens}")


def check_family_kernels(seed: int) -> dict:
    """Phase (b) at the families' shapes: K1 at Gemma-3-12B's prefill (4 rows
    of 1536 slots, 16 query heads over 8 kv heads, head_dim 256, window 1024
    and none), Phi-3-mini's (head_dim 96) and Qwen3-30B-A3B's (8 rows of 128,
    32 query heads over 4 kv heads); K2 at their decode steps with the
    window; K6 at Gemma-3-12B's continuous batching (8 rows of 1100-2000
    slots, window 1024), at Phi-3-mini's head_dim and at Qwen3-30B-A3B's
    group of 8. Each held to its plain
    version, absolutely and relative to the output's scale, and timed beside
    its bound and SDPA. Returns {kernel: {shape name: entry}}. Draws from
    its own generator, so the other checks' inputs stay as they were."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 12)
    run = {"flash_fwd": _flash_at, "fused_decode": _decode_at, "paged_decode": _paged_at}
    results = {}
    for kernel, shapes in FAMILY_KERNEL_SHAPES.items():
        for name, shape in shapes.items():
            e = run[kernel](gen, *shape)
            results.setdefault(kernel, {})[name] = e
            print(f"[family shapes] {kernel} {name} ({e['shape']}): max_abs_err "
                  f"{e['max_abs_err']:.3e} (tol {KERNEL_ATOL}), grad_ratio "
                  f"{e['grad_ratio']:.4f} at u = 2^-7 (at most 1), {e['ms']:.4f} ms, plain "
                  f"{e['plain_ms']:.4f} ms, sdpa {e['library_ms']:.4f} ms, bound "
                  f"{e['bound_ms']:.4f} ms ({e['bound_by']})" + (
                      f", wrapper's host cost {e['host_us']:.1f} us a call" if "host_us" in e
                      else "") + (
                      f"; against the tiled plain version {e['tiled_err']:.3e}, grad_ratio "
                      f"{e['tiled_grad_ratio']:.4f}, two runs bitwise equal" if "tiled_err" in e
                      else ""))
    return results


# K4 / K5 at the families' training shapes: (b, s, h, kvh, d, window, softcap),
# bf16, causal, rows right-padded to phase (e)'s lengths
FAMILY_BWD_SHAPES = {
    "phi3_mini_train": (TRAIN_ROWS, TRAIN_SEQ, 32, 32, 96, 2047, None),
    "gemma3_12b_train_window_1024": (TRAIN_ROWS, TRAIN_SEQ, 16, 8, 256, 1024, None),
    "gemma3_12b_train_global": (TRAIN_ROWS, TRAIN_SEQ, 16, 8, 256, None, None),
    # google/gemma-2-9b: 16 over 8 heads, head_dim 256, window 4096, softcap 50
    "gemma2_9b_train_cap_50": (TRAIN_ROWS, TRAIN_SEQ, 16, 8, 256, 4096, 50.0),
}


def check_family_backward(seed: int) -> dict:
    """K5 (dQ) and K4 (dK/dV) at the families' training shapes
    (FAMILY_BWD_SHAPES): held to the plain backward on K1's output and
    logsumexp (``grad_ratio`` at most 1), and timed between CUDA events
    beside their plain versions, their operation bounds and the library's
    backward (``_bwd_timed``: SDPA's, or compiled flex_attention's with a
    softcap). Returns {kernel: {shape name: entry}}. Draws from its own
    generator."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    lengths = _train_lengths(seed)
    results = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, (b, s, h, kvh, d, window, cap) in FAMILY_BWD_SHAPES.items():
        q, k, v, qpos, valid = _flash_inputs(gen, b=b, sq=s, skv=s, h=h, kvh=kvh, d=d)
        for row, n in enumerate(lengths):
            valid[row, n:] = 0
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        kw = dict(scale=d ** -0.5, is_causal=True, sliding_window=window, logit_cap=cap)
        errs, ratios = _bwd_errors(q, k, v, qpos, valid, do, twice=d == 256, **kw)
        del ratios["dv_tensors"]
        if any(r > 1.0 for r in ratios.values()):
            raise AssertionError(f"flash backward kernels disagree with their plain version at "
                                 f"{name}: max_abs_err {errs}, ratios {ratios}")
        t = _bwd_timed(q, k, v, qpos, valid, do, **kw)
        shape = (f"B={b} S={s} H={h} KVH={kvh} D={d} window={window}"
                 + (f" softcap={cap}" if cap else "") + f", right-padded to {lengths}")
        for kernel, key, grads in (("flash_bwd_dq", "dq", ("dq",)),
                                   ("flash_bwd_dkv", "dkv", ("dk", "dv"))):
            results[kernel][name] = dict(
                max_abs_err=max(errs[g] for g in grads),
                grad_ratio=max(ratios[g] for g in grads), ms=t[f"{key}_ms"],
                plain_ms=t[f"{key}_plain_ms"], bound_ms=t[f"{key}_bound"],
                bound_by=t[f"{key}_by"], library_ms=t["library_ms"], library=t["library"],
                shape=shape)
        print(f"[family shapes] flash_bwd {name} ({shape}), {t['visible']} visible (row, slot) "
              f"pairs: " + _bwd_times_text(t) + "; worst grad_ratio " + ", ".join(
                  f"{n} {r:.3f}" for n, r in ratios.items()) + " (tol 1)"
              + ("; two runs bitwise equal" if d == 256 else ""))
        del q, k, v, do, t
        gc.collect()
        torch.cuda.empty_cache()
    return results


# --------------------------------------------------------------------- (b), MoE
# Qwen3-30B-A3B's layer: 128 experts of 768 over hidden 2048, 8 a token, at a
# decode step's rows (8) and a prefill's (8 x 128)
MOE_LAYER = dict(e=128, h=2048, i=768, k=8)
MOE_PRODUCT_ROWS = (BATCH, BATCH * PROMPT)
# bf16 routes against the float32 loop: gate, up, their product and each
# expert's output are each rounded to bf16 (2^-8 relative), so a route is
# held within 1/32 of the output's scale; float32 within TOLERANCE[f32]
MOE_BF16_SCALE_TOL = 2.0 ** -5


def moe_loop(x, wg, wu, wd, weights, idx, act=torch.nn.functional.silu) -> torch.Tensor:
    """The plain per-expert loop in float32 (reads the routing to the host):
    each expert on the tokens that picked it, its weights widened alone, the
    weighted rows added."""
    x = x.float()
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in idx.unique().tolist():
        rows, slot = (idx == e).nonzero(as_tuple=True)
        inner = act(x[rows] @ wg[e].float()) * (x[rows] @ wu[e].float())
        out.index_add_(0, rows, (inner @ wd[e].float()) * weights[rows, slot, None])
    return out


def check_moe_products(seed: int) -> list:
    """Phase (b), the expert products (no Pallas kernel: ``jax.lax.ragged_dot``
    and the dense einsums are XLA's, so the port computes them with library
    calls, ``ops/moe.py``): at Qwen3-30B-A3B's layer shapes and 8 and 1024
    rows, the ``dense`` and ``ragged`` routes held to each other and to
    ``moe_loop`` in float32 (the ragged route on its padded product there)
    and in bf16 (the grouped product; run twice, bitwise equal, and once
    under ``no_host_sync``), then timed in bf16 beside their bound (the
    bytes of the experts the routing touches, or the T·k rows' operations)
    and three ``torch.bmm`` over all experts (the yardstick). Returns one
    entry per row count."""
    from transformers_tpu_torch.ops.moe import get_experts_fn, topk_routing

    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    e, h, i, k = (MOE_LAYER[n] for n in "ehik")
    act = torch.nn.functional.silu
    # [E, out, in] as the port stores them; the routes take transposed views
    stored = [0.02 * torch.randn(e, *shape, generator=gen, device="cuda")
              for shape in ((i, h), (i, h), (h, i))]
    entries = []
    for t in MOE_PRODUCT_ROWS:
        x = torch.randn(t, h, generator=gen, device="cuda")
        weights, idx = topk_routing(torch.randn(t, e, generator=gen, device="cuda"), k)
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            xd = x.to(dtype)
            ws = [w.to(dtype).transpose(1, 2) for w in stored]
            ref = moe_loop(xd, *ws, weights, idx)
            scale = float(ref.abs().max())
            outs = {r: get_experts_fn(r)(xd, *ws, weights, idx, act) for r in MOE_ROUTES}
            errs[dtype] = {r: max_err(o, ref) for r, o in outs.items()}
            errs[dtype]["dense_vs_ragged"] = max_err(outs["dense"], outs["ragged"])
            tol = TOLERANCE[dtype] if dtype == torch.float32 else MOE_BF16_SCALE_TOL * scale
            if max(errs[dtype].values()) > tol or not torch.isfinite(outs["ragged"]).all():
                raise AssertionError(f"moe routes at T={t} {dtype}: {errs[dtype]} (tol {tol:.3e})")
            if dtype == torch.bfloat16:
                with no_host_sync():
                    again = get_experts_fn("ragged")(xd, *ws, weights, idx, act)
                torch.cuda.synchronize()
                if not torch.equal(again, outs["ragged"]):
                    raise AssertionError(f"moe ragged route at T={t}: two runs differ")
                routes = {r: device_ms(lambda r=r: get_experts_fn(r)(xd, *ws, weights, idx, act))
                          for r in MOE_ROUTES}
                xe = xd.expand(e, t, h).contiguous()

                def library():
                    inner = act(torch.bmm(xe, ws[0])) * torch.bmm(xe, ws[1])
                    return torch.bmm(inner, ws[2])

                library_ms = device_ms(library)
                del xe
                # the host's cost a call (at 8 rows the card's time is below it)
                sorted_expert, order = torch.sort(idx.reshape(-1), stable=True)
                xs = xd.index_select(0, order // k)
                ends = torch.searchsorted(sorted_expert, torch.arange(e, device="cuda"),
                                          right=True).to(torch.int32)
                host = {r: host_us(lambda r=r: get_experts_fn(r)(xd, *ws, weights, idx, act),
                                   calls=32) for r in MOE_ROUTES}
                host["grouped_mm"] = host_us(lambda: torch._grouped_mm(xs, ws[0], offs=ends),
                                             calls=32)
            del outs, ref
        touched = int(idx.unique().numel())
        nbytes = touched * 3 * h * i * 2 + 2 * t * h * 2
        bound, by = bound_ms(nbytes, 2.0 * t * k * 3 * h * i)
        entry = dict(name=f"moe_experts_T{t}", rows=t, experts_touched=touched,
                     dense_ms=routes["dense"], ragged_ms=routes["ragged"], library_ms=library_ms,
                     library="torch.bmm over all 128 experts (gate, up, down)",
                     bound_ms=bound, bound_by=by, host_us=host,
                     max_abs_err={str(d).split(".")[1]: v for d, v in errs.items()})
        entries.append(entry)
        print(f"[moe products] T={t} rows (Qwen3-30B-A3B's layer: E={e} H={h} I={i} k={k}, "
              f"{touched} experts touched): f32 |route - loop| dense "
              f"{errs[torch.float32]['dense']:.3e}, ragged (padded product) "
              f"{errs[torch.float32]['ragged']:.3e} (tol {TOLERANCE[torch.float32]}); bf16 dense "
              f"{errs[torch.bfloat16]['dense']:.3e}, ragged {errs[torch.bfloat16]['ragged']:.3e}, "
              f"dense vs ragged {errs[torch.bfloat16]['dense_vs_ragged']:.3e} (tol 2^-5 of the "
              f"scale); ragged twice bitwise, no host sync; bf16 dense {routes['dense']:.4f} ms, "
              f"ragged {routes['ragged']:.4f} ms, bmm over all experts {library_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}); the host's cost a call: dense "
              f"{host['dense']:.1f} us, ragged {host['ragged']:.1f} us, one _grouped_mm "
              f"{host['grouped_mm']:.1f} us")
    del stored
    gc.collect()
    torch.cuda.empty_cache()
    return entries


def g3_cb_prompts(seed: int, vocab: int) -> list:
    rng = np.random.default_rng(seed + 14)
    return [[int(t) for t in rng.integers(1, vocab, size=int(rng.integers(G3_CB_LENS[0],
                                                                           G3_CB_LENS[1] + 1)))]
            for _ in range(G3_CB_REQUESTS)]


def check_gemma3_cb(model, seed: int, card: str) -> dict:
    """Gemma-3-12B through continuous batching at 16 steps per sync, the
    graph engine held to an uncaptured one (``cb_graph_vs_uncaptured``) and
    profiled on a third run. Returns the graph engine's counts."""
    vocab = model.config.vocab_size
    prompts = g3_cb_prompts(seed, vocab)
    run = cb_graph_vs_uncaptured("gemma3 cb", model, prompts, 16, card, new=G3_CB_NEW,
                                 settings=G3_CB_ENGINE)
    profile_run("gemma3 continuous batching, 16 steps per sync (graph)",
                lambda: run_cb(run["engine"], shifted(prompts, vocab, 2), "prof",
                               new=G3_CB_NEW), run["wall"], card)
    return run["counts"]


def check_gemma3(seed: int, card: str) -> dict:
    """Phase (i), part 1: Gemma-3-12B's text decoder at full width, its depth
    cut to ``G3_LAYERS`` (bf16, random weights from ``seed``, about 23.5 GB
    at its 48 layers): the 2-layer
    checkpoint round trip, static generate (graph against step loop, timed,
    profiled), continuous batching, then the generated tokens teacher-forced
    (the model is freed there). Returns the paths' launch counts."""
    check_load_path(seed, card, "gemma3_text", GEMMA3_12B)
    model = build_decoder(GEMMA3_12B, G3_LAYERS, torch.bfloat16, seed, model_type="gemma3_text")
    sliding = sum(t == "sliding_attention" for t in model.config.layer_types)
    print(f"[gemma3] {G3_LAYERS} of {GEMMA3_12B['num_hidden_layers']} layers, {sliding} of them "
          f"sliding "
          f"(window {GEMMA3_12B['sliding_window']}, local rope), "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters in bf16")
    ids, mask = generate_inputs(seed, model.config.vocab_size, G3_PROMPT, G3_PADS)
    out, counts = generate_graph_vs_loop("gemma3", model, ids, mask, G3_NEW, card, timed=True)
    paths = {"gemma3_12b_generate": counts}
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    paths["gemma3_12b_continuous_batching"] = check_gemma3_cb(model, seed, card)
    teacher_force(model, out, mask, prompt=G3_PROMPT, label="gemma3 teacher-force",
                  release=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def moe_family_times(label: str, model, ids, mask, new: int, hbm: float, card: str) -> None:
    """A 4-layer MoE family's prefill ms and decode ms/step on the graph path
    (medians of 3; its program was captured by ``generate_graph_vs_loop``)
    beside the step's weight-stream bound on its route, the default dense
    one (``moe_stream``), at the copy rate measured in the run."""
    graph, eager = _generate_runs(model, ids, mask, new)
    stream = moe_stream(model, lambda: eager(max_new_tokens=new), rows=ids.shape[0])
    prefill = _median_ms(lambda: graph(max_new_tokens=1))
    total = _median_ms(lambda: graph(max_new_tokens=new))
    step = (total - prefill) / (new - 1)
    nbytes = stream["fixed"] + stream["touched"]["dense"] * stream["blocks"] * stream["expert"]
    print(f"[{label} timed] B={ids.shape[0]} prompt={ids.shape[1]} new={new} bf16, "
          f"{model.config.num_hidden_layers} layers ({stream['blocks']} of them MoE), dense route: "
          f"prefill {prefill:.2f} ms, decode {step:.3f} ms/step; the step's weight stream "
          f"{nbytes / 1e9:.2f} GB over the measured {hbm / 1e12:.3f} TB/s: bound "
          f"{nbytes / hbm * 1e3:.3f} ms/step, {nbytes / hbm * 1e3 / step:.2f} of the step's time "
          f"({card})")


def check_families(seed: int, card: str, geometries: dict = FAMILY_GEOMETRIES) -> dict:
    """Phase (i), part 2 (and phase (k)'s ``MOE_FAMILY_GEOMETRIES``): each
    family at 4 layers of its published width (bf16, random weights; the MoE
    families on the default dense route; a family in ``FULL_DEPTH`` at all
    its layers): static generate at batch 4, prompt 128, 16 new tokens,
    graph against step loop bitwise with exact launches (``kernel_layers``:
    K2 never for Gemma2, whose softcap keeps decode on the plain path, nor on
    Laguna's full layers, nor for the families whose rope or post-rope norms
    JAX keeps off its fused decode), then the tokens teacher-forced; an MoE
    family is also timed (``moe_family_times``).
    Returns each family's launch counts."""
    paths, hbm = {}, None
    for model_type, (source, geometry) in geometries.items():
        t0 = time.perf_counter()
        layers = (geometry["num_hidden_layers"] if model_type in FULL_DEPTH else FAMILY_LAYERS)
        model = build_decoder(geometry, layers, torch.bfloat16, seed, model_type=model_type)
        ids, mask = generate_inputs(seed, model.config.vocab_size, FAMILY_PROMPT, FAMILY_PADS)
        attn = model.model.layers[0].self_attn
        head_dim = (getattr(attn, "head_dim", None)
                    or f"{attn.qk_head_dim} (q/k), {attn.v_head_dim} (v)")
        out, counts = generate_graph_vs_loop(model_type, model, ids, mask, FAMILY_NEW, card)
        moe = any(isinstance(m, expert_modules()) for m in model.modules())
        if moe:
            hbm = hbm or measured_hbm_rate()
            moe_family_times(model_type, model, ids, mask, FAMILY_NEW, hbm, card)
        # an MoE family's float32 run widens its bf16 weights at each call:
        # a float32 copy of MiniMax-M2's or Cohere2-MoE's 4 layers would not fit
        force = teacher_force_moe if moe else teacher_force
        force(model, out, mask, prompt=FAMILY_PROMPT, label=f"{model_type} teacher-force",
              f32_in_place=moe)
        paths[f"{model_type}_generate"] = counts
        del model
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[families] {model_type} ({source}, {layers} of "
              f"{geometry['num_hidden_layers']} layers, head_dim {head_dim}; K1 "
              f"{counts['flash_fwd']} calls, K2 on {counts['fused_decode'] // (FAMILY_NEW - 1)} "
              f"layers): "
              f"{time.perf_counter() - t0:.1f} s")
    return paths


# --------------------------------------------------------------------- (j)
def moe_cb_prompts(seed: int, vocab: int) -> list:
    rng = np.random.default_rng(seed + 15)
    lo, hi = MOE_CB_LENS
    return [[int(t) for t in rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1)))]
            for _ in range(MOE_CB_REQUESTS)]


def measured_hbm_rate() -> float:
    """Bytes a second of a 2 GiB device-to-device copy (read and write), the
    best of three timings of five copies."""
    a = torch.empty(2 ** 30, dtype=torch.bfloat16, device="cuda")
    b = torch.empty_like(a)
    ms = min(event_ms(lambda: b.copy_(a)) for _ in range(3))
    del a, b
    torch.cuda.empty_cache()
    return 2 * 2 ** 31 / (ms * 1e-3)


def expert_modules() -> tuple:
    """The port's expert modules: ``ops/moe.py``'s stacked ``Experts`` and
    gpt-oss's own; each is called as (x, routing weights, routing indices)."""
    from transformers_tpu_torch.models.gpt_oss.modeling_gpt_oss import GptOssExperts
    from transformers_tpu_torch.ops.moe import Experts

    return Experts, GptOssExperts


def moe_stream(model, run, rows: int = BATCH) -> dict:
    """The decode step's weight stream: every weight but the embedding table
    (a few rows read; counted where it is also the tied lm_head, read whole)
    and the experts (``fixed`` bytes), one expert's bytes,
    the number of expert blocks (``blocks``), and the experts a block each
    route reads: all on the dense route, and on the ragged one as many as a
    decode step's ``rows`` pick, on average over one uncaptured ``run``
    (``experts_touched``; also printed)."""
    blocks = [m for m in model.modules() if isinstance(m, expert_modules())]
    in_experts = sum(p.numel() for m in blocks for p in m.parameters())
    e = next(iter(blocks[0].parameters())).shape[0]
    params = sum(p.numel() for p in model.parameters())
    itemsize = model.model.embed_tokens.weight.element_size()
    table = 0 if model.config.tie_word_embeddings else model.model.embed_tokens.weight.numel()
    picked = experts_touched(run, rows)
    print(f"[moe stream] decode steps' rows touch {min(picked)}-{max(picked)} experts a layer, "
          f"{sum(picked) / len(picked):.2f} on average, of {e} (the dense route reads all); "
          f"the KV cache is left out of the bound")
    return dict(fixed=itemsize * (params - in_experts - table),
                expert=itemsize * in_experts / (len(blocks) * e), blocks=len(blocks),
                touched={"dense": e, "ragged": sum(picked) / len(picked)})


def expert_calls(run) -> list:
    """(rows, dtype of x, routing indices, routing weights) of every call of
    an expert module of any model over one ``run`` (uncaptured: a global hook
    reads the routing back)."""
    kinds, calls = expert_modules(), []

    def hook(module, args, out):
        if isinstance(module, kinds):
            calls.append((args[0].shape[0], args[0].dtype, args[2].detach().clone(),
                           args[1].detach().clone()))

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        run()
    finally:
        handle.remove()
    return calls


def experts_touched(run, rows: int = BATCH) -> list:
    """The distinct experts each decode step's ``rows`` pick in each layer,
    over one ``run``; a prefill's rows are left out."""
    return [int(idx.unique().numel()) for n, _, idx, _ in expert_calls(run) if n == rows]


@contextlib.contextmanager
def pinned_routing(layers: list, b: int, total: int):
    """Every expert module's call takes, for its tokens, the routing in
    ``layers`` ((indices, weights) of each MoE layer in call order over a
    [b, total] sequence) in place of its router's: a call on all but the last
    position (a prefill), on the last one (a decode step) or on all of them.
    The routers still run; only what they hand the experts is replaced."""
    kinds = expert_modules()
    per_layer = [(idx.view(b, total, -1), w.view(b, total, -1)) for idx, w in layers]
    seen = [0]

    def hook(module, args):
        if not isinstance(module, kinds):
            return None
        idx, w = per_layer[seen[0] % len(per_layer)]
        seen[0] += 1
        s = args[0].shape[0] // b
        start = 0 if s == total - 1 else total - s
        return (args[0], w[:, start:start + s].reshape(b * s, -1).to(args[1].dtype),
                idx[:, start:start + s].reshape(b * s, -1), *args[3:])

    handle = torch.nn.modules.module.register_module_forward_pre_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def teacher_force_moe(model, seq, prompt_mask, label: str, prompt: int = PROMPT,
                      f32_in_place: bool = False) -> None:
    """How often the plain bf16 path's router picks another set of experts
    for a token than the float32 run's, layer by layer over the full
    sequence; then ``teacher_force`` with every run's experts routed as the
    float32 run routes them (``pinned_routing``). Where a top k flips under
    bf16 rounding, two runs part by whole experts: at random weights' near
    ties one flip in one row of the kernel path, and none in the plain path's,
    moved Mistral4's last-position logits 0.70 from float32 against the plain
    path's 0.27 while K1 agreed with its plain version within 0.0039 at that
    step's shape. Pinned, the hold compares the kernels' numerics, not
    which side of a tie bf16 noise fell on."""
    b, total = seq.shape
    rows = seq.numel()
    mask = torch.cat([prompt_mask, torch.ones((b, total - prompt), dtype=torch.int32,
                                              device="cuda")], dim=1)
    pos = (mask.cumsum(-1) - 1).clamp_min(0)
    calls = expert_calls(lambda: plain_and_f32_logits(model, [(seq, mask, pos)],
                                                      f32_in_place=f32_in_place))

    def picks(dtype):
        return [(idx, w) for r, d, idx, w in calls if r == rows and d == dtype]

    share = [float((a.sort(dim=-1).values != f.sort(dim=-1).values).any(dim=-1).float().mean())
             for (a, _), (f, _) in zip(picks(model.dtype), picks(torch.float32), strict=True)]
    print(f"[{label}] routing of the {rows} teacher-forced tokens, plain bf16 path against "
          f"float32: {sum(share) / len(share):.4f} of tokens pick another set of experts, on "
          f"average over {len(share)} MoE layers (first {share[0]:.4f}, last {share[-1]:.4f})")
    with pinned_routing(picks(torch.float32), b, total):
        teacher_force(model, seq, prompt_mask, prompt=prompt, f32_in_place=f32_in_place,
                      label=f"{label}, routing pinned to float32's")


SPAN = "span::"
PHASE = "phase::"
OUR_KERNELS = re.compile(r"(flash_fwd|fused_decode|paged_split|paged_combine)\w*kernel")
GEMM_KERNELS = re.compile(r"gemm|cutlass|xmma|cublas|nvjet", re.I)
SPAN_NAMES = ("experts", "shared experts", "router", "attention", "eager attention",
              "mla expansion", "norms", "lm_head", "other")
SHARED_EXPERTS = ("shared_experts", "shared_expert", "shared_mlp")  # an MoE block's children


@contextlib.contextmanager
def labelled_spans(phases: dict, model=None):
    """Each call of the attention block, the eager attention inside it (where
    no kernel takes the call: gpt-oss's sinks, the static decode of families
    that K2 does not take, multi-head latent attention with values narrower
    than its keys), the re-expansion of MLA's cached latents through
    ``kv_b_proj`` (``mla expansion``), the MoE block (the router and the experts' call),
    the experts, ``model``'s shared experts (``SHARED_EXPERTS``), every norm
    and the lm_head runs inside a ``record_function`` span named for it, and
    each of ``phases`` ((name, object, method) triples) inside one named for
    the phase, so that a profile can credit each kernel to the innermost span
    and the phase that launched it."""
    from torch.profiler import record_function
    from transformers_tpu_torch.core.module import HeadwiseLayerNorm, LayerNorm, RMSNorm
    from transformers_tpu_torch.models.deepseek_v3.modeling_deepseek_v3 import (
        DeepseekV3Attention, DeepseekV3MoE)
    from transformers_tpu_torch.models.gpt_oss.modeling_gpt_oss import GptOssExperts, GptOssMLP
    from transformers_tpu_torch.models.llama import modeling_llama
    from transformers_tpu_torch.models.llama.modeling_llama import (LlamaAttention,
                                                                    LlamaForCausalLM)
    from transformers_tpu_torch.ops import attention
    from transformers_tpu_torch.ops.moe import Experts, SparseMoeBlock

    def wrap(fn, name):
        @functools.wraps(fn)
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    targets = [(LlamaAttention, "forward", SPAN + "attention"),
               (DeepseekV3Attention, "forward", SPAN + "attention"),
               (DeepseekV3Attention, "expand_kv", SPAN + "mla expansion"),
               (attention, "eager_attention", SPAN + "eager attention"),
               (modeling_llama, "cached_attention_bhsd", SPAN + "eager attention"),
               (SparseMoeBlock, "forward", SPAN + "router"),
               (DeepseekV3MoE, "forward", SPAN + "router"),
               (GptOssMLP, "forward", SPAN + "router"),
               (Experts, "forward", SPAN + "experts"), (GptOssExperts, "forward", SPAN + "experts"),
               (RMSNorm, "forward", SPAN + "norms"), (LayerNorm, "forward", SPAN + "norms"),
               (HeadwiseLayerNorm, "forward", SPAN + "norms"),
               (LlamaForCausalLM, "compute_logits", SPAN + "lm_head")]
    targets += [(owner, method, PHASE + phase) for phase, owner, method in phases]
    blocks = [m for m in (model.modules() if model is not None else ())
              if isinstance(m, (SparseMoeBlock, GptOssMLP))]
    targets += [(getattr(m, name), "forward", SPAN + "shared experts") for m in blocks
                for name in SHARED_EXPERTS if getattr(m, name, None) is not None]
    patched = []
    for owner, method, name in targets:
        own = method in vars(owner)  # else an instance's bound method, or inherited
        patched.append((owner, method, getattr(owner, method) if own else None))
        setattr(owner, method, wrap(getattr(owner, method), name))
    try:
        yield
    finally:
        for owner, method, fn in reversed(patched):
            if fn is None:
                delattr(owner, method)
            else:
                setattr(owner, method, fn)


def moe_breakdown(label: str, run, phases: list, card: str, model=None) -> dict:
    """Device time of one uncaptured ``run`` (a captured graph replays the
    same kernels) by phase and by what launched each kernel (``SPAN_NAMES``):
    the attention block, the router (the gate and top-k; the rest of the MoE
    block's call), the experts (their products, the GEMMs, also apart from
    the sort, gathers and combine), the RMSNorms, the lm_head and the rest
    (embedding, residual adds, rope tables, the draw, copies). From
    torch.profiler with host events: each kernel is credited to the innermost
    span of the op that launched it. The port's attention kernels are summed
    by name over the run (K1 serves prefills, K2 and K6 decode steps), and
    the kernel time that no op took is printed with its largest names."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with labelled_spans(phases, model), profile(activities=[ProfilerActivity.CPU,
                                                     ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    us = defaultdict(float)
    credited, device = defaultdict(float), defaultdict(float)
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not getattr(ev, "is_user_annotation", False):
            device[ev.name] += ev.self_device_time_total
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        span, phase, p = None, "other", ev
        while p is not None:
            if span is None and p.name.startswith(SPAN):
                span = p.name[len(SPAN):]
            if p.name.startswith(PHASE):
                phase = p.name[len(PHASE):]
            p = p.cpu_parent
        span = span or "other"
        for kernel in ev.kernels:
            credited[kernel.name] += kernel.duration
            us[(phase, span)] += kernel.duration
            if span == "experts" and GEMM_KERNELS.search(kernel.name):
                us[(phase, "expert products")] += kernel.duration
    out = {}
    for phase in dict.fromkeys(name for name, _, _ in phases):
        row = {span: t / 1e3 for (ph, span), t in us.items() if ph == phase}
        out[phase] = row
        print(f"[{label} breakdown] {phase}: device "
              f"{sum(row.get(n, 0.0) for n in SPAN_NAMES):.3f} ms = " + ", ".join(
                  f"{n} {row.get(n, 0.0):.3f}" for n in SPAN_NAMES)
              + f" ms; the expert products (GEMMs) {row.get('expert products', 0.0):.3f} ms of "
              f"the experts' ({card})")
    ours = {OUR_KERNELS.search(name).group(0): t / 1e3 for name, t in device.items()
            if OUR_KERNELS.search(name)}
    missing = sorted(((t - credited.get(n, 0.0), n) for n, t in device.items()), reverse=True)
    print(f"[{label} breakdown] the port's attention kernels over the run: " + ", ".join(
        f"{n} {t:.3f} ms" for n, t in sorted(ours.items())) + f"; kernels credited "
        f"{sum(credited.values()) / 1e3:.3f} ms of the trace's {sum(device.values()) / 1e3:.3f} "
        f"ms (outside the phases {sum(t for (ph, _), t in us.items() if ph == 'other') / 1e3:.3f}"
        f" ms), not credited: " + ", ".join(f"{t / 1e3:.3f} ms {n[:60]}" for t, n in missing[:3])
        + f"; the trace read in {time.perf_counter() - t0:.1f} s")
    out["attention kernels"] = ours
    return out


def moe_routes_logits(label: str, model, ids, mask) -> None:
    """The prompt's logits at every valid position under each route (the
    kernel path: K1 over the local k/v) and in float32 (the same weights
    widened, eager attention, the dense route). Neither route may be more
    than twice as far from float32 as the other; their distance from each
    other is printed against the logits' scale."""
    pos = (mask.cumsum(-1) - 1).clamp_min(0)
    valid = mask.bool()
    logits = {}
    with torch.inference_mode():
        for route in MOE_ROUTES:
            model.config.experts_implementation = route
            logits[route] = model(ids, attention_mask=mask, position_ids=pos).logits[valid]
        model.config.experts_implementation = "dense"
        model.config.attn_implementation = "eager"
        with computing_in(model, torch.float32):
            ref = model(ids, attention_mask=mask, position_ids=pos).logits[valid]
        model.config.attn_implementation = None
    scale = float(ref.abs().max())
    far = {route: max_err(logits[route], ref) for route in MOE_ROUTES}
    between = max_err(logits["dense"], logits["ragged"])
    finite = all(bool(torch.isfinite(v).all()) for v in logits.values())
    print(f"[{label} routes] prefill logits at {int(valid.sum())} valid positions (|max| "
          f"{scale:.3f}): |dense - f32| {far['dense']:.4f}, |ragged - f32| {far['ragged']:.4f}, "
          f"|dense - ragged| {between:.4f} = {between / scale:.4f} of the scale; each route "
          f"within twice the other's distance from f32")
    if not finite or far["dense"] > 2 * far["ragged"] or far["ragged"] > 2 * far["dense"]:
        raise AssertionError(f"{label}: the two routes' prefill logits disagree")


def moe_generate_route(label: str, model, route: str, ids, mask, stream_bytes, hbm: float,
                       card: str) -> tuple:
    """Static generate under ``route`` (gpt-oss's experts take none: every
    expert computes every token, the dense route's work): graph against step
    loop (``generate_graph_vs_loop``, launches exact), then prefill ms and
    decode ms/step of the graph path (medians of 3), tokens/s, the profiled
    idle share, peak memory, the step's weight-stream bound (``moe_stream``)
    and the breakdown by span. Returns (ids, launch counts, the breakdown)."""
    from transformers_tpu_torch.generation.utils import StaticDecode

    layers = model.config.num_hidden_layers
    model.config.experts_implementation = route
    torch.cuda.reset_peak_memory_stats()
    out, counts = generate_graph_vs_loop(f"{label} {route}", model, ids, mask, NEW, card)
    graph, eager = _generate_runs(model, ids, mask, NEW)
    prefill = _median_ms(lambda: graph(max_new_tokens=1))
    total = _median_ms(lambda: graph(max_new_tokens=NEW))
    step = (total - prefill) / (NEW - 1)
    kernels = profile_run(f"{label} {route} (graph)", lambda: graph(max_new_tokens=NEW), total,
                          card)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    peak = torch.cuda.max_memory_allocated()
    touched = stream_bytes["touched"][route]
    nbytes = stream_bytes["fixed"] + touched * stream_bytes["blocks"] * stream_bytes["expert"]
    print(f"[{label} {route}] B={BATCH} prompt={PROMPT} new={NEW} bf16, {layers} layers: "
          f"prefill {prefill:.2f} ms, decode {step:.3f} ms/step, {BATCH * 1e3 / step:.1f} decode "
          f"tokens/s, {BATCH * NEW * 1e3 / total:.1f} tokens/s over the whole generate; device "
          f"idle share {1 - busy / total:.3f}; peak memory {peak / 1e9:.2f} GB; the step's "
          f"weight stream {nbytes / 1e9:.2f} GB ({touched:.1f} experts a layer) over the "
          f"measured {hbm / 1e12:.3f} TB/s: bound {nbytes / hbm * 1e3:.3f} ms/step, "
          f"{nbytes / hbm * 1e3 / step:.2f} of the step's time (at the published "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms) ({card})")
    split = moe_breakdown(f"{label} {route}", lambda: eager(max_new_tokens=MOE_SPLIT_NEW),
                          [("prefill", StaticDecode, "prefill"), ("decode", StaticDecode, "step")],
                          card, model)
    return out, counts, split


def check_qwen3_moe(seed: int, card: str) -> dict:
    """Phase (j): Qwen3-30B-A3B at full width, its depth cut to
    ``QWEN3_MOE_LAYERS`` (bf16, random weights from ``seed``, built on the
    card): the 2-layer checkpoint round trip (one
    tensor per expert in the file); static generate at phase (c)'s shape under
    each route, graph against step loop, timed, profiled and broken down; the
    routes' prefill logits against each other and float32; continuous
    batching on the ragged route, graph engine against uncaptured; the
    generated tokens teacher-forced against float32 (the same weights
    widened: a float32 copy would take 122 GB). Returns the paths' launches."""
    from transformers_tpu_torch.generation.continuous_batching import ContinuousBatchingEngine

    check_load_path(seed, card, "qwen3_moe", QWEN3_MOE)
    hbm = measured_hbm_rate()
    model = build_decoder(QWEN3_MOE, QWEN3_MOE_LAYERS, torch.bfloat16, seed,
                          model_type="qwen3_moe")
    cfg = model.config
    experts = sum(p.numel() for n, p in model.named_parameters() if ".experts." in n)
    params = sum(p.numel() for p in model.parameters())
    print(f"[qwen3_moe] {QWEN3_MOE_SOURCE}: {cfg.num_hidden_layers} of "
          f"{QWEN3_MOE['num_hidden_layers']} layers, "
          f"{params / 1e9:.3f} B parameters ({experts / 1e9:.3f} B in the experts), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; HBM copy rate measured "
          f"{hbm / 1e12:.3f} TB/s ({card})")
    ids, mask = generate_inputs(seed, cfg.vocab_size)
    graph, eager = _generate_runs(model, ids, mask, NEW)
    stream = moe_stream(model, lambda: eager(max_new_tokens=NEW))
    runs = {route: moe_generate_route("qwen3_moe", model, route, ids, mask, stream, hbm, card)
            for route in MOE_ROUTES}
    same = int((runs["dense"][0][:, PROMPT:] == runs["ragged"][0][:, PROMPT:]).sum())
    print(f"[qwen3_moe routes] greedy tokens: {same} of {BATCH * NEW} equal between the routes "
          f"(bf16 near-ties of random weights)")
    moe_routes_logits("qwen3_moe", model, ids, mask)
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    paths = {"qwen3_moe_generate": runs["ragged"][1]}
    model.config.experts_implementation = "ragged"
    prompts = moe_cb_prompts(seed, cfg.vocab_size)
    cb = cb_graph_vs_uncaptured("qwen3_moe cb", model, prompts, 16, card, new=MOE_CB_NEW)
    paths["qwen3_moe_continuous_batching"] = cb["counts"]
    del cb
    engine = ContinuousBatchingEngine(model, steps_per_sync=16, **CB_ENGINE)
    engine.runner._capture = False
    runner = engine.runner
    shortest = sorted(prompts, key=len)[:2]
    moe_breakdown("qwen3_moe cb ragged",
                  lambda: run_cb(engine, shifted(shortest, cfg.vocab_size, 3), "split",
                                 new=MOE_SPLIT_NEW),
                  [("prefill", runner, "prefill_chunk"), ("decode", runner, "decode_step"),
                   ("decode", runner, "decode_multi")], card)
    del engine, runner
    gc.collect()
    torch.cuda.empty_cache()
    teacher_force_moe(model, runs["ragged"][0], mask, label="qwen3_moe teacher-force",
                      f32_in_place=True)
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# --------------------------------------------------------------------- (k)
def _moe_model(label: str, source: str, geometry: dict, model_type: str, seed: int,
               hbm: float, card: str, layers: int = 0):
    """``geometry`` in bf16, random weights from ``seed``, at ``layers`` layers
    (0: its full depth); prints its size."""
    full = geometry["num_hidden_layers"]
    model = build_decoder(geometry, layers or full, torch.bfloat16, seed, model_type=model_type)
    blocks = [m for m in model.modules() if isinstance(m, expert_modules())]
    experts = sum(p.numel() for m in blocks for p in m.parameters())
    params = sum(p.numel() for p in model.parameters())
    depth = "no cut" if model.config.num_hidden_layers == full else f"cut from {full}"
    print(f"[{label}] {source}: {model.config.num_hidden_layers} layers ({depth}), "
          f"{params / 1e9:.3f} B parameters ({experts / 1e9:.3f} B in the experts), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated; HBM copy rate measured "
          f"{hbm / 1e12:.3f} TB/s ({card})")
    return model


def check_moe_model(label: str, source: str, geometry: dict, seed: int, card: str,
                    hbm: float) -> dict:
    """A ``label`` (its ``model_type``) MoE model at full width and depth (bf16,
    random weights from ``seed``; phase (k)'s OLMoE-1B-7B, phase (l)'s
    ERNIE-4.5-21B-A3B): the 2-layer checkpoint round trip (one tensor per
    expert); static generate at phase (c)'s shape under each route, graph
    against step loop, timed, profiled and split by span; the routes' prompt
    logits against each other and float32; continuous batching on the ragged
    route (phase (j)'s traffic), graph engine against uncaptured; the
    generated tokens teacher-forced against float32 from the same bf16
    weights. Returns the paths' launches."""
    check_load_path(seed, card, label, geometry)
    model = _moe_model(label, source, geometry, label, seed, hbm, card)
    vocab = model.config.vocab_size
    ids, mask = generate_inputs(seed, vocab)
    eager = _generate_runs(model, ids, mask, NEW)[1]
    stream = moe_stream(model, lambda: eager(max_new_tokens=NEW))
    runs = {route: moe_generate_route(label, model, route, ids, mask, stream, hbm, card)
            for route in MOE_ROUTES}
    same = int((runs["dense"][0][:, PROMPT:] == runs["ragged"][0][:, PROMPT:]).sum())
    print(f"[{label} routes] greedy tokens: {same} of {BATCH * NEW} equal between the routes "
          f"(bf16 near-ties of random weights)")
    moe_routes_logits(label, model, ids, mask)
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    model.config.experts_implementation = "ragged"
    cb = cb_graph_vs_uncaptured(f"{label} cb", model, moe_cb_prompts(seed, vocab), 16, card,
                                new=MOE_CB_NEW)
    paths = {f"{label}_generate": runs["ragged"][1],
             f"{label}_continuous_batching": cb["counts"]}
    del cb
    gc.collect()
    torch.cuda.empty_cache()
    teacher_force_moe(model, runs["ragged"][0], mask, label=f"{label} teacher-force",
                      f32_in_place=True)
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def check_gpt_oss(seed: int, card: str, hbm: float) -> dict:
    """Phase (k), gpt-oss-20b at full width, its depth cut to ``GPT_OSS_LAYERS``
    (bf16, random weights from ``seed``): the 2-layer checkpoint round trip (the experts' stacked
    tensors whole); static generate at phase (c)'s shape, graph against step
    loop with no kernel launched (its sinks keep every attention call on the
    eager path, as the JAX package keeps them off its Pallas kernels), timed,
    profiled and split by span (the eager attention apart); the generated
    tokens teacher-forced against float32 from the same bf16 weights (a
    float32 copy of all 24 layers would take 84 GB). Returns the path's
    launches."""
    check_load_path(seed, card, "gpt_oss", GPT_OSS)
    model = _moe_model("gpt_oss", GPT_OSS_SOURCE, GPT_OSS, "gpt_oss", seed, hbm, card,
                       GPT_OSS_LAYERS)
    ids, mask = generate_inputs(seed, model.config.vocab_size)
    eager = _generate_runs(model, ids, mask, NEW)[1]
    stream = moe_stream(model, lambda: eager(max_new_tokens=NEW))
    out, counts, _ = moe_generate_route("gpt_oss", model, "dense", ids, mask, stream, hbm,
                                        card)
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    teacher_force_moe(model, out, mask, label="gpt_oss teacher-force", f32_in_place=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"gpt_oss_generate": counts}


def check_moe_families(seed: int, card: str) -> dict:
    """Phase (k): OLMoE-1B-7B at full depth, gpt-oss-20b at 8 layers, then Phi-3.5-MoE
    and Laguna at 4 layers (``check_families``). Returns the paths' launches."""
    hbm = measured_hbm_rate()
    paths = check_moe_model("olmoe", OLMOE_SOURCE, OLMOE, seed, card, hbm)
    paths.update(check_gpt_oss(seed, card, hbm))
    paths.update(check_families(seed, card, MOE_FAMILY_GEOMETRIES))
    return paths


# --------------------------------------------------------------------- (l)
def cr7b_cb_prompts(seed: int, vocab: int) -> list:
    rng = np.random.default_rng(seed + 16)
    lo, hi = CR7B_CB_LENS
    return [[int(t) for t in rng.integers(1, vocab, size=int(rng.integers(lo, hi + 1)))]
            for _ in range(CR7B_CB_REQUESTS)]


def check_command_r7b(seed: int, card: str, hbm: float) -> dict:
    """Phase (l), Command-R7B at full width and depth (bf16, random weights
    from ``seed``, ~16 GB): the 2-layer checkpoint round trip (tied: no
    ``lm_head`` in the file); static generate at batch 2 over 5120-slot
    prompts left-padded by 0 and 512 (the window cuts every sliding layer's
    range), 32 new, graph against step loop bitwise (K1 32 per prefill, K2
    never: interleaved rope and the NoPE full layers keep the decode step on
    the eager cached attention), the graph path timed beside the step's
    bound at the copy rate ``hbm``, profiled, split by span, with its peak
    memory; continuous batching of 8 requests of 4600-5100 tokens (K1
    per prefill chunk, K6 per decode step, with the window), graph engine
    against uncaptured; then the generated tokens teacher-forced against
    float32 from the same bf16 weights. Returns the paths' launches."""
    from transformers_tpu_torch.generation.utils import StaticDecode

    check_load_path(seed, card, "cohere2", CR7B)
    model = build_decoder(CR7B, CR7B["num_hidden_layers"], torch.bfloat16, seed,
                          model_type="cohere2")
    cfg = model.config
    full = [i for i, t in enumerate(cfg.layer_types) if t == "full_attention"]
    print(f"[command_r7b] {CR7B_SOURCE}: {cfg.num_hidden_layers} layers (no cut), full attention "
          f"with no rope at {full}, the others sliding at {cfg.sliding_window}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated ({card})")
    ids, mask = generate_inputs(seed, cfg.vocab_size, CR7B_PROMPT, CR7B_PADS)
    torch.cuda.reset_peak_memory_stats()
    out, counts = generate_graph_vs_loop("command_r7b", model, ids, mask, CR7B_NEW, card)
    graph, eager = _generate_runs(model, ids, mask, CR7B_NEW)
    prefill = _median_ms(lambda: graph(max_new_tokens=1))
    total = _median_ms(lambda: graph(max_new_tokens=CR7B_NEW))
    step = (total - prefill) / (CR7B_NEW - 1)
    kernels = profile_run("command_r7b (graph)", lambda: graph(max_new_tokens=CR7B_NEW), total,
                          card)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    # a step reads every weight (the tied table whole, for the logits) and,
    # per row, the kv slots each layer sees: the window, or the whole context
    ctx = CR7B_PROMPT + CR7B_NEW
    seen = sum(min(ctx, cfg.sliding_window) if t == "sliding_attention" else ctx
               for t in cfg.layer_types)
    head_dim = model.model.layers[0].self_attn.head_dim
    kv = len(CR7B_PADS) * seen * 2 * cfg.num_key_value_heads * head_dim * 2
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters()) + kv
    b = len(CR7B_PADS)
    print(f"[command_r7b] graph: B={b} prompt={CR7B_PROMPT} new={CR7B_NEW} bf16, "
          f"{cfg.num_hidden_layers} layers: prefill {prefill:.2f} ms, decode {step:.3f} ms/step, "
          f"{b * 1e3 / step:.1f} decode tokens/s, {b * CR7B_NEW * 1e3 / total:.1f} tokens/s over "
          f"the whole generate (medians of 3); device idle share {1 - busy / total:.3f}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; the step's stream "
          f"{nbytes / 1e9:.2f} GB (weights, and {kv / 1e9:.3f} GB of kv slots in the windows) over the measured "
          f"{hbm / 1e12:.3f} TB/s: bound {nbytes / hbm * 1e3:.3f} ms/step, "
          f"{nbytes / hbm * 1e3 / step:.2f} of the step's time ({card})")
    moe_breakdown("command_r7b", lambda: eager(max_new_tokens=MOE_SPLIT_NEW),
                  [("prefill", StaticDecode, "prefill"), ("decode", StaticDecode, "step")], card,
                  model)
    paths = {"command_r7b_generate": counts}
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cb = cb_graph_vs_uncaptured("command_r7b cb", model, cr7b_cb_prompts(seed, cfg.vocab_size),
                                16, card, new=CR7B_CB_NEW, settings=CR7B_CB_ENGINE)
    print(f"[command_r7b cb] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"({CR7B_CB_ENGINE['num_blocks']} pages of {CR7B_CB_ENGINE['block_size']}) ({card})")
    paths["command_r7b_continuous_batching"] = cb["counts"]
    del cb
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    teacher_force(model, out, mask, prompt=CR7B_PROMPT, label="command_r7b teacher-force",
                  f32_in_place=True)
    print(f"[command_r7b teacher-force] peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"GB (the plain path's logits at every position of a 256000-token vocabulary) ({card})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def check_moe_bases(seed: int, card: str) -> dict:
    """Phase (l): ERNIE-4.5-21B-A3B (``check_moe_model``) and Command-R7B at
    full depth, then OLMo-2, MiniMax-M2, Command-R, Cohere2-MoE, HunYuan
    dense and MoE at 4 layers and ERNIE-4.5-0.3B at its 18 (``check_families``).
    Returns the paths' launches."""
    hbm = measured_hbm_rate()
    paths = check_moe_model("ernie4_5_moe", ERNIE_MOE_SOURCE, ERNIE_MOE, seed, card, hbm)
    paths.update(check_command_r7b(seed, card, hbm))
    paths.update(check_families(seed, card, BASE_FAMILY_GEOMETRIES))
    return paths


# --------------------------------------------------------------------- (m)
# DeepSeek-V2-Lite at full width and depth: deepseek-ai/DeepSeek-V2-Lite's
# config.json (27 layers, hidden 2048, 16 heads of multi-head latent
# attention: no q rank, kv rank 512, q/k 128 + 64 rope, v 128; layer 0 dense
# at 10944, 26 MoE layers of 64 experts of 1408, top 6 by softmax, 2 shared;
# 102400-token vocabulary; yarn factor 40): 15.7e9 parameters, 31.4 GB in bf16
DSV2_LITE_SOURCE = "deepseek-ai/DeepSeek-V2-Lite"
DSV2_LITE = dict(vocab_size=102400, hidden_size=2048, intermediate_size=10944,
                 num_hidden_layers=27, num_attention_heads=16, num_key_value_heads=16,
                 q_lora_rank=None, kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                 v_head_dim=128, n_routed_experts=64, n_shared_experts=2, num_experts_per_tok=6,
                 moe_intermediate_size=1408, first_k_dense_replace=1, topk_method="greedy",
                 n_group=1, topk_group=1, routed_scaling_factor=1.0, norm_topk_prob=False,
                 rms_norm_eps=1e-6, rope_theta=10000.0, max_position_embeddings=163840,
                 rope_scaling={"type": "yarn", "factor": 40.0, "beta_fast": 32, "beta_slow": 1,
                               "mscale": 0.707, "mscale_all_dim": 0.707,
                               "original_max_position_embeddings": 4096},
                 tie_word_embeddings=False)
# DeepSeek-V3 at full width (DeepseekV3Config's defaults, the published
# widths: hidden 7168, 128 heads, q rank 1536, kv rank 512, dense layers of
# 18432, 256 routed experts of 2048 in 8 groups, top 8 from 4 groups, one
# shared, 129280-token vocabulary), depth cut to 4 of 61: the 3 dense layers
# and one MoE layer, ~30 GB in bf16
DSV3_SOURCE = "DeepseekV3Config's defaults (deepseek-ai/DeepSeek-V3's widths)"
DSV3 = dict(num_hidden_layers=61, max_position_embeddings=4096, tie_word_embeddings=False)
DSV3_LAYERS = 4
# GLM-4.5-Air at full width (Glm4MoeConfig's defaults: hidden 4096, 96 query
# heads over 8 kv heads at head_dim 128, half of it rotated, layer 0 dense at
# 10944, 128 experts of 1408, top 8, one shared; 151552-token vocabulary)
# with biases on q/k/v, depth cut to 4 of 46
GLM45_AIR_SOURCE = "Glm4MoeConfig's defaults (zai-org/GLM-4.5-Air's widths), attention_bias"
GLM45_AIR = dict(num_hidden_layers=46, attention_bias=True, tie_word_embeddings=False)
# the other families of the tree at 4 layers of their configs' widths,
# through check_families
DEEPSEEK_FAMILY_GEOMETRIES = {
    # Dots1Config's defaults (hidden 4608, 32 over 32 heads) with its expert
    # fields, None by default, filled as dots.llm1's (128 routed experts of
    # 1408, 2 shared, top 6) and head_dim 128 (the default's 4608 / 32 = 144
    # is no kernel's head_dim; dots.llm1's is 128)
    "dots1": ("Dots1Config's defaults, experts and head_dim of rednote-hilab/dots.llm1", dict(
        num_hidden_layers=62, n_routed_experts=128, n_shared_experts=2, num_experts_per_tok=6,
        head_dim=128, tie_word_embeddings=False)),
    # SolarOpenConfig's defaults: 64 over 8 heads (a group of 8), full rotary,
    # 128 experts of 1280, top 8, one shared, every layer sparse
    "solar_open": ("SolarOpenConfig's defaults (upstage/Solar-Open-100B)", dict(
        num_hidden_layers=48, tie_word_embeddings=False)),
    # Mistral4Config's defaults: 32 heads of MLA with q/k 64 + 64 and v 128
    # (so K1 takes its attention), 128 experts of 2048, top 4, no shared
    # experts, every layer sparse, llama-4's attention temperature
    "mistral4": ("Mistral4Config's defaults", dict(num_hidden_layers=36,
                                                   tie_word_embeddings=False)),
}


@contextlib.contextmanager
def f32_experts_one_at_a_time():
    """Stacked experts computing in float32 (a ``computing_in`` run) loop over
    the experts the tokens picked, each expert's weights widened alone: both
    routes widen a whole stacked parameter at once, and DeepSeek-V3's one
    MoE layer holds 11.3e9 expert weights, 45 GB in float32, beside which
    neither route's products fit on the card. Calls in another type take the
    route as they are. Reads the routing to the host: uncaptured runs only."""
    from transformers_tpu_torch.ops.moe import Experts

    real = Experts.forward

    def forward(self, x, routing_weights, routing_idx, implementation=None):
        if self.dtype != torch.float32:
            return real(self, x, routing_weights, routing_idx, implementation)
        gate, up, down = (getattr(self, n).transpose(1, 2) for n in self.stacked_names)
        return moe_loop(x, gate, up, down, routing_weights, routing_idx, self.act)

    Experts.forward = forward
    try:
        yield
    finally:
        Experts.forward = real


def mla_share(label: str, split: dict, steps: int) -> None:
    """Of the decode steps' device time in ``split`` (``moe_breakdown``'s), the
    multi-head latent attention's share: the block's own kernels (the
    projections and the rope), the history's re-expansion through
    ``kv_b_proj`` and the eager attention over it."""
    row = split["decode"]
    total = sum(row.get(n, 0.0) for n in SPAN_NAMES)
    parts = {n: row.get(n, 0.0) for n in ("attention", "mla expansion", "eager attention")}
    mla = sum(parts.values())
    print(f"[{label} mla] decode: multi-head latent attention {mla / steps:.3f} ms of the "
          f"step's {total / steps:.3f} ms device time ({mla / total:.3f}): the block's "
          f"projections and rope {parts['attention'] / steps:.3f}, the history's re-expansion "
          f"through kv_b_proj {parts['mla expansion'] / steps:.3f}, the eager attention "
          f"{parts['eager attention'] / steps:.3f} ms a step (uncaptured steps)")


def check_mla_model(label: str, source: str, geometry: dict, seed: int, card: str, hbm: float,
                    layers: int = 0) -> dict:
    """A multi-head latent attention model (``label`` its ``model_type``) at
    full width, bf16, random weights from ``seed``, ``layers`` deep (0: all
    of them): the 2-layer checkpoint round trip (one tensor per expert, the
    router in the hub's layout); the continuous-batching engine's refusal;
    static generate at phase (c)'s shape under each route, graph against
    step loop (no kernel: the values are narrower than the keys, so every
    attention call is the eager one, as in JAX), timed against the step's
    weight stream, profiled, split by span with the MLA's share of a decode
    step; the routes' prompt logits; the generated tokens teacher-forced
    against float32 from the same bf16 weights, its experts computed one at
    a time (``f32_experts_one_at_a_time``). Returns the path's launches."""
    from transformers_tpu_torch.generation.continuous_batching import ContinuousBatchingEngine

    check_load_path(seed, card, label, geometry)
    model = _moe_model(label, source, geometry, label, seed, hbm, card, layers)
    try:
        ContinuousBatchingEngine(model, **CB_ENGINE)
    except NotImplementedError as err:
        print(f"[{label}] continuous batching refused at construction, as required: {err}")
    else:
        raise AssertionError(f"{label}: the continuous-batching engine took an MLA model")
    cache = model.init_cache(BATCH, PROMPT + NEW)
    print(f"[{label}] latent cache: {len(cache.keys)} layers of latents "
          f"{tuple(cache.keys[0].shape)} and rope keys {tuple(cache.values[0].shape)}, "
          f"{sum(t.numel() * t.element_size() for t in cache.keys + cache.values) / 1e6:.2f} MB "
          f"for {BATCH} x {PROMPT + NEW} slots")
    del cache
    ids, mask = generate_inputs(seed, model.config.vocab_size)
    eager = _generate_runs(model, ids, mask, NEW)[1]
    stream = moe_stream(model, lambda: eager(max_new_tokens=NEW))
    runs = {}
    for route in MOE_ROUTES:
        runs[route] = moe_generate_route(label, model, route, ids, mask, stream, hbm, card)
        mla_share(f"{label} {route}", runs[route][2], MOE_SPLIT_NEW - 1)
    same = int((runs["dense"][0][:, PROMPT:] == runs["ragged"][0][:, PROMPT:]).sum())
    print(f"[{label} routes] greedy tokens: {same} of {BATCH * NEW} equal between the routes "
          f"(bf16 near-ties of random weights)")
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    with f32_experts_one_at_a_time():
        moe_routes_logits(label, model, ids, mask)
        model.config.experts_implementation = "ragged"
        teacher_force_moe(model, runs["ragged"][0], mask, label=f"{label} teacher-force",
                          f32_in_place=True)
    paths = {f"{label}_generate": runs["ragged"][1]}
    del model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def check_glm4_5_air(seed: int, card: str, hbm: float) -> dict:
    """GLM-4.5-Air at full width, 4 layers (bf16, random weights from
    ``seed``): the 2-layer checkpoint round trip; static generate at phase
    (c)'s shape on the dense route, graph against step loop (K1 per layer per
    prefill at the group of 12; no K2: the half-width rope takes the eager
    cached attention, as in JAX), timed beside the step's weight stream;
    continuous batching (phase (j)'s traffic, the ragged route, K1 per chunk
    and K6 per step at the group of 12), graph engine against uncaptured;
    the generated tokens teacher-forced. Returns the paths' launches."""
    check_load_path(seed, card, "glm4_moe", GLM45_AIR)
    model = _moe_model("glm4_moe", GLM45_AIR_SOURCE, GLM45_AIR, "glm4_moe", seed, hbm, card,
                       FAMILY_LAYERS)
    vocab = model.config.vocab_size
    ids, mask = generate_inputs(seed, vocab)
    out, counts = generate_graph_vs_loop("glm4_moe", model, ids, mask, NEW, card)
    moe_family_times("glm4_moe", model, ids, mask, NEW, hbm, card)
    model._decode_program = None
    gc.collect()
    torch.cuda.empty_cache()
    model.config.experts_implementation = "ragged"
    cb = cb_graph_vs_uncaptured("glm4_moe cb", model, moe_cb_prompts(seed, vocab), 16, card,
                                new=MOE_CB_NEW)
    paths = {"glm4_moe_generate": counts, "glm4_moe_continuous_batching": cb["counts"]}
    del cb
    gc.collect()
    torch.cuda.empty_cache()
    model.config.experts_implementation = None
    teacher_force_moe(model, out, mask, label="glm4_moe teacher-force", f32_in_place=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return paths


def check_deepseek_tree(seed: int, card: str) -> dict:
    """Phase (m): DeepSeek-V2-Lite at full depth and DeepSeek-V3 at full width
    cut to 4 layers (``check_mla_model``), GLM-4.5-Air at 4 layers
    (``check_glm4_5_air``), then dots.llm1, Solar-Open and Mistral4 at 4
    layers (``check_families``). Returns the paths' launches."""
    hbm = measured_hbm_rate()
    paths = check_mla_model("deepseek_v2", DSV2_LITE_SOURCE, DSV2_LITE, seed, card, hbm)
    paths.update(check_mla_model("deepseek_v3", DSV3_SOURCE, DSV3, seed, card, hbm,
                                 DSV3_LAYERS))
    paths.update(check_glm4_5_air(seed, card, hbm))
    paths.update(check_families(seed, card, DEEPSEEK_FAMILY_GEOMETRIES))
    return paths


# --------------------------------------------------------------------- (n)
# the encoders' batch: rows of ENC_SEQ tokens, right-padded to lengths drawn
# from the seed in ENC_MIN_LEN..ENC_SEQ (the first row full)
ENC_ROWS, ENC_SEQ, ENC_MIN_LEN = 32, 512, 64
BERT_LARGE = dict(vocab_size=30522, hidden_size=1024, num_hidden_layers=24,
                  num_attention_heads=16, intermediate_size=4096, max_position_embeddings=512,
                  type_vocab_size=2, layer_norm_eps=1e-12, pad_token_id=0)
ROBERTA_LARGE = dict(vocab_size=50265, hidden_size=1024, num_hidden_layers=24,
                     num_attention_heads=16, intermediate_size=4096,
                     max_position_embeddings=514, type_vocab_size=1, layer_norm_eps=1e-5,
                     pad_token_id=1, bos_token_id=0, eos_token_id=2)
XLMR_LARGE = dict(ROBERTA_LARGE, vocab_size=250002)
DISTILBERT_BASE = dict(vocab_size=30522, dim=768, n_layers=6, n_heads=12, hidden_dim=3072,
                       max_position_embeddings=512, pad_token_id=0)
MODERNBERT_BASE = {}  # ModernBertConfig's defaults are answerdotai/ModernBERT-base's widths
ENCODER_LEGS = (  # label, source, model_type, head, geometry, rows, seq
    ("bert-large seq-cls", "google-bert/bert-large-uncased", "bert", "sequence", BERT_LARGE,
     ENC_ROWS, ENC_SEQ),
    ("bert-large mlm", "google-bert/bert-large-uncased", "bert", "masked_lm", BERT_LARGE,
     ENC_ROWS, ENC_SEQ),
    ("roberta-large seq-cls", "FacebookAI/roberta-large", "roberta", "sequence",
     ROBERTA_LARGE, ENC_ROWS, ENC_SEQ),
    ("xlm-roberta-large mlm", "FacebookAI/xlm-roberta-large", "xlm-roberta", "masked_lm",
     XLMR_LARGE, 8, ENC_SEQ),
    ("distilbert-base seq-cls", "distilbert-base-uncased", "distilbert", "sequence",
     DISTILBERT_BASE, ENC_ROWS, ENC_SEQ),
    ("modernbert-base mlm 16x512", "answerdotai/ModernBERT-base", "modernbert", "masked_lm",
     MODERNBERT_BASE, 16, ENC_SEQ),
    ("modernbert-base mlm 1x8192", "answerdotai/ModernBERT-base", "modernbert", "masked_lm",
     MODERNBERT_BASE, 1, 8192),
)
# K1's bidirectional mode at the encoders' shapes: (label, b, s, h, d)
ENCODER_K1_SHAPES = (("bert_large_32x512_right_padded", ENC_ROWS, ENC_SEQ, 16, 64),
                     ("modernbert_global_1x8192", 1, 8192, 12, 64))
PIPELINE_WIDTH = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
                      num_attention_heads=12, intermediate_size=3072)  # bert-base-uncased
PIPELINE_DECODER = dict(vocab_size=30522, hidden_size=512, intermediate_size=1536,
                        num_hidden_layers=4, num_attention_heads=8, num_key_value_heads=4,
                        head_dim=64, max_position_embeddings=256, tie_word_embeddings=True)
NLI_LABELS = {0: "contradiction", 1: "neutral", 2: "entailment"}
NER_LABELS = {0: "O", 1: "B-PER", 2: "I-PER", 3: "B-LOC", 4: "I-LOC"}


def encoder_lengths(seed: int, rows: int, seq: int) -> list:
    rng = np.random.default_rng(seed + rows + seq)
    lengths = [int(n) for n in rng.integers(ENC_MIN_LEN, seq + 1, size=rows)]
    lengths[0] = seq
    return lengths


def right_padded_valid(lengths: list, seq: int) -> torch.Tensor:
    slots = torch.arange(seq, device="cuda")[None, :]
    return (slots < torch.tensor(lengths, device="cuda")[:, None]).to(torch.int32)


def check_encoder_kernels(seed: int) -> dict:
    """K1's bidirectional mode (``is_causal=False``, which no path ran on the
    card before the encoders) at ENCODER_K1_SHAPES, bf16: held to its plain
    version (every row, pad rows included, sees each valid slot of its row;
    absolute, lse, and relative to the output's scale) and to
    ``flash_attention_tiled_plain`` at the kernel's kv tile, run twice
    (bitwise), timed beside its bound and SDPA with the key-padding mask as a
    boolean tensor. Right padding puts a row's dead slots in its last tiles,
    ending mid-tile."""
    from transformers_tpu_torch.ops.flash_attention import (flash_attention,
                                                            flash_attention_tiled_plain)

    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    out = {}
    for label, b, s, h, d in ENCODER_K1_SHAPES:
        lengths = encoder_lengths(seed, b, s)
        q, k, v, qpos, _ = _flash_inputs(gen, b=b, sq=s, skv=s, h=h, kvh=h, d=d)
        valid = right_padded_valid(lengths, s)
        kw = dict(scale=d ** -0.5, is_causal=False)
        err, lse_err, ratio = _flash_errors(q, k, v, qpos, valid, **kw)
        _family_hold("flash (bidirectional)", err, ratio)
        if lse_err > LSE_ATOL:
            raise AssertionError(f"flash bidirectional lse: {lse_err:.3e}")
        args = dict(q_positions=qpos, kv_valid=valid, **kw)
        first, second = flash_attention(q, k, v, **args), flash_attention(q, k, v, **args)
        tiled, _ = flash_attention_tiled_plain(q, k, v, qpos, valid, block_kv=WG_TILE, **kw)
        tiled_err = max_err(first, tiled)
        bitwise = torch.equal(first, second)
        if tiled_err > KERNEL_ATOL or not bitwise:
            raise AssertionError(f"flash bidirectional against its tiled plain version: "
                                 f"{tiled_err:.3e}, two runs equal bit for bit: {bitwise}")
        del first, second, tiled
        timed = flash_timed(q, k, v, qpos, valid, is_causal=False, iters=20 if s <= 512 else 3)
        out[label] = dict(max_abs_err=err, grad_ratio=ratio, lse_err=lse_err,
                          tiled_err=tiled_err, bitwise=bitwise, **timed,
                          shape=f"B={b} S={s} H={h} D={d}, right-padded rows of "
                                f"{min(lengths)}-{max(lengths)} slots, bidirectional")
        print(f"[encoder shapes] flash_fwd {label} ({out[label]['shape']}): max_abs_err "
              f"{err:.3e} (tol {KERNEL_ATOL}), grad_ratio {ratio:.4f}, lse {lse_err:.3e}, tiled "
              f"{tiled_err:.3e}, bitwise {bitwise}; {timed['ms']:.4f} ms, plain "
              f"{timed['plain_ms']:.4f} ms, sdpa {timed['library_ms']:.4f} ms, bound "
              f"{timed['bound_ms']:.4f} ms ({timed['bound_by']})")
        del q, k, v
        torch.cuda.empty_cache()
    return out


def encoder_batch(model_type: str, config, rows: int, seq: int, seed: int) -> dict:
    """Right-padded rows of random ids (never the pad id where a row is
    live), the pad id after; BERT's second half of each row as segment 1."""
    lengths = encoder_lengths(seed, rows, seq)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    pad = config.pad_token_id
    ids = torch.randint(3, config.vocab_size, (rows, seq), generator=g, device="cuda")
    ids = torch.where(ids == pad, 3, ids)
    mask = right_padded_valid(lengths, seq)
    batch = {"input_ids": torch.where(mask.bool(), ids, pad), "attention_mask": mask}
    if model_type == "bert":
        batch["token_type_ids"] = (torch.arange(seq, device="cuda")[None, :]
                                   >= torch.tensor(lengths, device="cuda")[:, None] // 2
                                   ).long() * mask
    return batch


def head_logits(out) -> torch.Tensor:
    """A head's output as one tensor: logits, or QA's start and end stacked."""
    if getattr(out, "logits", None) is not None:
        return out.logits
    return torch.stack([out.start_logits, out.end_logits], dim=-1)


def encoder_flops(model, head: str, rows: int, seq: int) -> float:
    """The forward's operations: 2 x every Linear weight that runs on each
    token (the pooler and the classifiers over one token a row left out) x
    the B x S tokens (padding included: the encoder computes every slot),
    the tied MLM decoder (vocab x hidden a token), and 4 x hidden per
    (query, slot) pair each layer's attention must score: every slot of the
    row on a global layer, the 2 x half-window + 1 nearest on a local one."""
    from transformers_tpu_torch.core.module import Linear

    cfg = model.config
    base = getattr(model, model.base_model_prefix)
    per_token = sum(m.weight.numel() for name, m in base.named_modules()
                    if isinstance(m, Linear) and "pooler" not in name)
    if head in ("masked_lm", "token", "qa"):
        per_token += sum(m.weight.numel() for name, m in model.named_modules()
                         if isinstance(m, Linear) and not name.startswith(
                             model.base_model_prefix + "."))
    if head == "masked_lm":
        per_token += cfg.vocab_size * cfg.hidden_size
    layers = getattr(cfg, "layer_types", None) or ["full_attention"] * cfg.num_hidden_layers
    window = getattr(cfg, "sliding_window", None) or seq
    attended = sum(seq if t == "full_attention" else min(seq, 2 * window + 1) for t in layers)
    return 2.0 * per_token * rows * seq + 4.0 * cfg.hidden_size * rows * seq * attended


def encoder_shares(label: str, run, model_cls, card: str) -> dict:
    """K1's and the eager attention's (ModernBERT's local layers: the window
    K1 does not take) shares of the device time of one ``run`` of
    ``model_cls.forward``, from ``moe_breakdown``'s profile."""
    split = moe_breakdown(label, run, [("forward", model_cls, "forward")], card)
    busy = sum(split["forward"].get(n, 0.0) for n in SPAN_NAMES)
    if busy == 0:
        print(f"[{label} profile] the profiler recorded no device time: shares not measured")
        return {}
    k1 = sum(t for n, t in split["attention kernels"].items() if n.startswith("flash_fwd"))
    eager = split["forward"].get("eager attention", 0.0)
    print(f"[{label} profile] device busy {busy:.3f} ms a forward: K1 {k1:.3f} ms "
          f"({k1 / busy:.1%}), eager attention {eager:.3f} ms ({eager / busy:.1%}) ({card})")
    return dict(busy_ms=busy, k1_ms=k1, k1_share=k1 / busy, eager_attention_ms=eager,
                eager_attention_share=eager / busy)


def hold_logits(label: str, kernel, plain, ref) -> float:
    """The kernel path's logits must be finite and no further from float32
    than twice the plain (eager) bf16 path is; returns |kernel - f32| /
    |plain - f32|."""
    err_kernel_f32, err_plain_f32 = max_err(kernel, ref), max_err(plain, ref)
    ratio = err_kernel_f32 / max(err_plain_f32, 1e-30)
    print(f"[{label}] logits (|max| {float(ref.abs().max()):.3f}): |kernel - plain| "
          f"{max_err(kernel, plain):.4f}, |plain - f32| {err_plain_f32:.4f}, |kernel - f32| "
          f"{err_kernel_f32:.4f}, ratio {ratio:.3f}")
    if not bool(torch.isfinite(kernel).all()) or err_kernel_f32 > 2 * err_plain_f32:
        raise AssertionError(f"{label}: kernel path logits disagree with the plain path")
    return ratio


def encoder_leg(label: str, source: str, model_type: str, head: str, geometry: dict,
                rows: int, seq: int, seed: int, card: str) -> dict:
    """One encoder at its published width and depth, bf16, random weights from
    ``seed``, through its auto class: K1's launches over one forward (one a
    layer; ModernBERT's global layers only), ms per forward, sequences/s,
    MFU, K1's and the eager attention's share (profiler), the leg's peak
    memory (its weights, batch, first logits and one forward: the peak above
    what was allocated when the leg began), and the head's logits at the live
    positions held to the plain path and to float32 (the same weights widened
    at each call). Returns the forward's launch counts."""
    from transformers_tpu_torch import (AutoConfig, AutoModelForMaskedLM,
                                        AutoModelForSequenceClassification)

    auto = {"sequence": AutoModelForSequenceClassification,
            "masked_lm": AutoModelForMaskedLM}[head]
    t0 = time.perf_counter()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    config = AutoConfig.for_model_type(model_type, **geometry, num_labels=3)
    model = auto.from_config(config, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    batch = encoder_batch(model_type, config, rows, seq, seed)
    fwd = functools.partial(model, **batch)
    layers = getattr(config, "layer_types", None) or ["full_attention"] * config.num_hidden_layers
    k1_layers = sum(t == "full_attention" for t in layers)
    with torch.inference_mode():
        _reset_counts()
        kernel = head_logits(fwd())
        torch.cuda.synchronize()
        counts = _read_counts()
        if counts != _expected(flash_fwd=k1_layers):
            raise AssertionError(f"{label}: launches {counts}, expected K1 {k1_layers}")
        ms = event_ms(fwd, iters=3)
        torch.cuda.reset_peak_memory_stats()
        fwd()
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        split = encoder_shares(label, fwd, type(model), card)
        model.config.attn_implementation = "eager"
        _reset_counts()
        plain = head_logits(fwd())
        if any(_read_counts().values()):
            raise AssertionError("the plain path launched a kernel")
        with computing_in(model, torch.float32):
            ref = head_logits(fwd())
        model.config.attn_implementation = None
    live = batch["attention_mask"].bool()
    if kernel.dim() == 2:  # one row of logits a sequence
        ratio = hold_logits(label, kernel, plain, ref)
    else:
        ratio = hold_logits(label, kernel[live], plain[live], ref[live])
    flops = encoder_flops(model, head, rows, seq)
    mfu = flops / (ms / 1e3 * BF16_FLOPS_PER_S)
    params = sum(p.numel() for p in model.parameters())
    print(f"[encoders] {label} ({source}, {config.num_hidden_layers} layers, "
          f"{params / 1e6:.1f} M parameters, B={rows} S={seq}, live tokens "
          f"{int(live.sum())} of {rows * seq}): {ms:.3f} ms a forward, "
          f"{rows / (ms / 1e3):.1f} sequences/s, mfu {mfu:.4f} ({flops / 1e12:.3f} TFLOP at "
          f"{BF16_FLOPS_PER_S / 1e12:.0f} TFLOP/s), peak {peak:.2f} GiB above the "
          f"{held / 2 ** 30:.2f} GiB held before, K1 {counts['flash_fwd']} "
          f"launches, logits ratio {ratio:.3f}; {time.perf_counter() - t0:.1f} s ({card})")
    del model, kernel, plain, ref
    gc.collect()
    torch.cuda.empty_cache()
    return dict(counts=counts, ms=ms, mfu=mfu, peak_gib=peak, ratio=ratio, **split)


def check_decoder_head(seed: int, card: str) -> dict:
    """``LlamaForSequenceClassification`` on phase (c)'s Llama-3-8B geometry
    at its 32 layers, 8 rows of 128 (right-padded by PADS, and pad ids inside
    rows 1 and 5): K1 causal once a layer, the pooled rows at each row's last
    non-pad token, the logits held to the plain path and float32. Returns
    the forward's launch counts."""
    from transformers_tpu_torch import (LlamaConfig, LlamaForSequenceClassification,
                                        last_token_indices)

    t0 = time.perf_counter()
    cfg = LlamaConfig(**GEOMETRY, max_position_embeddings=PROMPT, pad_token_id=0, num_labels=3,
                      bos_token_id=None, eos_token_id=None)
    model = LlamaForSequenceClassification(cfg, dtype=torch.bfloat16,
                                           device="cuda").init_weights(seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    ids = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT), generator=g, device="cuda")
    lengths = torch.tensor([PROMPT - p for p in PADS], device="cuda")
    mask = (torch.arange(PROMPT, device="cuda")[None, :] < lengths[:, None]).to(torch.int32)
    ids = ids * mask
    ids[1, 10] = ids[5, 3] = 0  # pad ids inside live rows: the mask keeps them
    with torch.inference_mode():
        _reset_counts()
        kernel = model(input_ids=ids, attention_mask=mask).logits
        torch.cuda.synchronize()
        counts = _read_counts()
        if counts != _expected(flash_fwd=cfg.num_hidden_layers):
            raise AssertionError(f"decoder head launches {counts}")
        ms = event_ms(lambda: model(input_ids=ids, attention_mask=mask), iters=3)
        model.config.attn_implementation = "eager"
        plain = model(input_ids=ids, attention_mask=mask).logits
        with computing_in(model, torch.float32):
            ref = model(input_ids=ids, attention_mask=mask).logits
        model.config.attn_implementation = None
    pooled = last_token_indices(ids, mask, 0).tolist()
    if pooled != (lengths - 1).tolist():
        raise AssertionError(f"pooled positions {pooled}, expected {(lengths - 1).tolist()}")
    ratio = hold_logits("llama seq-cls", kernel, plain, ref)
    print(f"[encoders] LlamaForSequenceClassification (Llama-3-8B geometry, 32 layers, B={BATCH}"
          f" S={PROMPT}): {ms:.3f} ms a forward, K1 {counts['flash_fwd']} launches (causal), "
          f"pooled at {pooled}, logits ratio {ratio:.3f}; {time.perf_counter() - t0:.1f} s "
          f"({card})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def write_wordpiece_vocab(directory: str, size: int) -> list:
    """A made-up WordPiece vocabulary of ``size`` entries: the specials, then
    words and ``##`` pieces; returns its words."""
    words = [f"w{i}" for i in range(size // 2)]
    pieces = [f"##p{i}" for i in range(size - 5 - len(words))]
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + pieces
    with open(os.path.join(directory, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("".join(t + "\n" for t in vocab))
    with open(os.path.join(directory, "tokenizer_config.json"), "w", encoding="utf-8") as f:
        json.dump({"do_lower_case": True, "mask_token": "[MASK]", "pad_token": "[PAD]",
                   "cls_token": "[CLS]", "sep_token": "[SEP]", "unk_token": "[UNK]"}, f)
    return words


def check_pipelines(seed: int, card: str) -> dict:
    """The seven text tasks once each through ``port.pipeline(task,
    model=<dir>, device="cuda")``: BERT-base-width models (12 layers, 768,
    random bf16 weights from ``seed``, ``id2label`` set for the classifier
    and the tagger) and a small Llama, each saved to a temporary directory
    with a made-up 30522-entry WordPiece ``vocab.txt``. Each task's output
    structure is checked and its ms per call (the second call) printed.
    Returns the launches of the timed calls."""
    import tempfile

    from transformers_tpu_torch import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                                        BertForSequenceClassification,
                                        BertForTokenClassification, BertModelStandalone,
                                        LlamaConfig, LlamaForCausalLM, pipeline)

    root = tempfile.mkdtemp(prefix="pipelines-")
    models = {
        "text-classification": (BertForSequenceClassification, dict(
            id2label=NLI_LABELS, label2id={v: k for k, v in NLI_LABELS.items()})),
        "token-classification": (BertForTokenClassification, dict(id2label=NER_LABELS)),
        "fill-mask": (BertForMaskedLM, {}),
        "feature-extraction": (BertModelStandalone, {}),
        "question-answering": (BertForQuestionAnswering, {}),
    }
    dirs = {}
    try:
        for task, (cls, extra) in models.items():
            d = dirs[task] = os.path.join(root, task)
            os.makedirs(d)
            cls(BertConfig(**PIPELINE_WIDTH, **extra), dtype=torch.bfloat16,
                device="cuda").init_weights(seed).save_pretrained(d)
            words = write_wordpiece_vocab(d, PIPELINE_WIDTH["vocab_size"])
        dirs["zero-shot-classification"] = dirs["text-classification"]
        d = dirs["text-generation"] = os.path.join(root, "text-generation")
        os.makedirs(d)
        LlamaForCausalLM(LlamaConfig(**PIPELINE_DECODER, pad_token_id=0, bos_token_id=2,
                                     eos_token_id=None), dtype=torch.bfloat16,
                         device="cuda").init_weights(seed).save_pretrained(d)
        write_wordpiece_vocab(d, PIPELINE_DECODER["vocab_size"])
        text = " ".join(words[7 * i + 3] for i in range(40))
        calls = {
            "text-classification": ((text,), {"top_k": 3}),
            "zero-shot-classification": ((text,), {"candidate_labels": words[:4]}),
            "token-classification": ((text,), {}),
            "fill-mask": ((text + " [MASK] " + text,), {"top_k": 5}),
            "feature-extraction": ((text,), {}),
            "question-answering": ((), {"question": " ".join(words[:6]), "context": text,
                                        "max_answer_len": 15}),
            "text-generation": ((text,), {"max_new_tokens": 16}),
        }
        counts = {}
        for task, (args, kw) in calls.items():
            pipe = pipeline(task, model=dirs[task], device="cuda")
            if pipe.model.device.type != "cuda":
                raise AssertionError(f"{task}: the model is on {pipe.model.device}")
            pipe(*args, **kw)  # warm-up (the decode graph's capture for text-generation)
            _reset_counts()
            outs = []
            ms = _timed(lambda: outs.append(pipe(*args, **kw)))
            counts[task] = _read_counts()
            out = outs[0]
            check_pipeline_output(task, out, args, kw)
            print(f"[pipelines] {task}: {ms:.2f} ms a call, K1 {counts[task]['flash_fwd']}, K2 "
                  f"{counts[task]['fused_decode']} launches; {str(out)[:100]} ({card})")
            del pipe
    finally:
        shutil.rmtree(root, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    total = {name: sum(c[name] for c in counts.values()) for name in _wrappers()}
    return total


def check_pipeline_output(task: str, out, args: tuple, kw: dict) -> None:
    """The structure each task's pipeline gives for one input."""
    def fail():
        raise AssertionError(f"{task}: unexpected output {str(out)[:300]}")

    def score_ok(x):
        return isinstance(x, float) and 0.0 <= x <= 1.0

    if task == "text-classification":
        if not (len(out) == 3 and all(o["label"] in NLI_LABELS.values() and score_ok(o["score"])
                                      for o in out)):
            fail()
    elif task == "zero-shot-classification":
        if not (sorted(out["labels"]) == sorted(kw["candidate_labels"])
                and abs(sum(out["scores"]) - 1.0) < 1e-6):
            fail()
    elif task == "token-classification":
        if not all(o["entity"] in NER_LABELS.values() and o["entity"] != "O"
                   and score_ok(o["score"]) and isinstance(o["index"], int) for o in out):
            fail()
    elif task == "fill-mask":
        if not (len(out) == kw["top_k"] and all(
                score_ok(o["score"]) and isinstance(o["token_str"], str) for o in out)):
            fail()
    elif task == "feature-extraction":
        if not (len(out) == 1 and len(out[0][0]) == PIPELINE_WIDTH["hidden_size"]
                and all(math.isfinite(x) for x in out[0][0])):
            fail()
    elif task == "question-answering":
        if not (isinstance(out["answer"], str) and 0 <= out["start"] <= out["end"]
                < out["start"] + kw["max_answer_len"] and score_ok(out["score"])):
            fail()
    elif task == "text-generation":
        if not (len(out) == 1 and out[0]["generated_text"].startswith(args[0])):
            fail()


def check_encoders(seed: int, card: str) -> tuple:
    """Phase (n): K1's bidirectional mode at the encoders' shapes
    (``check_encoder_kernels``), the five encoder families at their published
    widths and depths through their auto classes (``encoder_leg``), the
    Llama sequence classifier (``check_decoder_head``) and the seven text
    pipelines (``check_pipelines``). Returns (each path's launches, K1's
    entries at the encoder shapes)."""
    k1 = check_encoder_kernels(seed)
    paths, legs = {}, {}
    for label, source, model_type, head, geometry, rows, seq in ENCODER_LEGS:
        leg = encoder_leg(label, source, model_type, head, geometry, rows, seq, seed, card)
        paths[f"encoder {label}"] = leg.pop("counts")
        legs[label] = leg
    print(json.dumps({"encoders": legs}))
    paths["llama_sequence_classification"] = check_decoder_head(seed, card)
    paths["pipelines"] = check_pipelines(seed, card)
    return paths, k1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only-encoders", action="store_true",
                    help="run the build and phase (n) alone; no result line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the compiled flex_attention yardstick: its cache inside the checkout's
    # build directory, compiled in this process (no worker pool)
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "transformers_tpu_torch", "_build", "inductor")
    os.environ["TORCHINDUCTOR_COMPILE_THREADS"] = "1"
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
    if args.only_encoders:
        check_encoders(args.seed, card)
        lap("phase (n), the encoders, the task heads and the text pipelines")
        return 0
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    _reset_counts()
    kernels = [check_flash(gen), check_decode(gen, args.seed), *check_paged(gen, args.seed),
               check_static_decode(gen, args.seed)]
    family = {**check_family_kernels(args.seed), **check_family_backward(args.seed)}
    bwd, k1_train = check_flash_bwd(gen, args.seed)
    kernels[0].update(k1_train)
    kernels += bwd
    check_reference_cases(gen)
    for entry in kernels:  # the families' shapes (phase i) beside each kernel's main one
        if entry["name"] in family:
            entry["at_family_shapes"] = family[entry["name"]]
    kernels += check_quantized_linear(gen)
    moe_products = check_moe_products(args.seed)
    phase_b = _read_counts()  # K7 serves no path: its launches are phase (b)'s checks
    lap("phase (b), kernel holds")
    check_load_path(args.seed, card)
    model = build_model(args.seed)
    paths = {"generate": check_generate(model, args.seed, card)}
    lap("phase (c), load and generate")
    paths["continuous_batching"], cb_rates = check_cb(model, args.seed, card)
    lap("phase (d), continuous batching")
    paths["serving"] = check_serving(model, args.seed, card)
    lap("phase (h), serving")
    paths["beam_search"], paths["assisted"] = check_generation_routes(model, args.seed, card)
    lap("phase (g), generation routes")
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
    paths.update(check_gemma3(args.seed, card))
    lap("phase (i), Gemma-3-12B")
    paths.update(check_families(args.seed, card))
    lap("phase (i), the other families at 4 layers")
    gc.collect()
    torch.cuda.empty_cache()
    paths.update(check_qwen3_moe(args.seed, card))
    lap("phase (j), Qwen3-30B-A3B")
    paths.update(check_moe_families(args.seed, card))
    lap("phase (k), OLMoE-1B-7B, gpt-oss-20b, Phi-3.5-MoE and Laguna")
    paths.update(check_moe_bases(args.seed, card))
    lap("phase (l), ERNIE-4.5-21B-A3B, Command-R7B and the families on new bases")
    paths.update(check_deepseek_tree(args.seed, card))
    lap("phase (m), DeepSeek-V2-Lite, DeepSeek-V3, GLM-4.5-Air and the DeepSeek tree")
    encoder_paths, kernels[0]["at_encoder_shapes"] = check_encoders(args.seed, card)
    paths.update(encoder_paths)
    lap("phase (n), the encoders, the task heads and the text pipelines")
    paths["train"] = check_train(args.seed, card)
    lap("phase (e), training at the Llama-3-8B width")
    paths["train_gemma3"] = check_train_gemma3(args.seed, card)
    lap("phase (e), training Gemma-3-12B at 6 layers")
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
    print(json.dumps({"moe_products": moe_products}))
    print(json.dumps({"kernels": kernels}))
    print(f"[time] smoke total: {time.perf_counter() - start:.1f} s")
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
