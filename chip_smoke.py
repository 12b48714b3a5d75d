#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``transformers_tpu_torch``) on one card.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure exits non-zero:

(a) build every CUDA kernel from ``transformers_tpu_torch/csrc`` (one nvcc per
    source, all at once) and print the card's name and power limit;
(b) hold each kernel against its plain PyTorch version at the main path's
    shapes, in bf16, and time the kernel, the plain version and one PyTorch
    library call that computes the same function (a yardstick only: the port
    never calls it), beside the least time the card could take; then hold
    them on the cases of the reference's tests/ops files in float32, float16
    and bf16, at head_dim 64, 128 and 256;
(c) the main path at the Llama-3-8B geometry in bf16 with random weights
    from ``--seed``: a full-width, 2-layer checkpoint written with the port's
    safetensors writer and read back by ``from_pretrained``; then
    ``generate`` (batch 8, prompt 128, 32 new tokens, greedy) on the 32-layer
    model, with both kernels' launch counts checked per layer; then the
    generated tokens teacher-forced through the plain path.

Prints one ``{"kernels": [...]}`` line, the card's name and power limit, and
ends with ``{"ok": true, "device": {...}}``. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time

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

# Kernel vs plain: both compute in f32 from the same inputs and round the
# output once to the storage type; sums run in another order, so outputs of
# magnitude up to ~4 differ by about one step of that type (bf16 2^-8, f16
# 2^-11 relative), and in f32 by a few ulps of the sums.
TOLERANCE = {torch.bfloat16: 2e-2, torch.float16: 5e-3, torch.float32: 2e-5}
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
def phase_build() -> dict:
    from transformers_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build()
    secs = time.perf_counter() - t0
    for name in cuda_build.KERNELS:
        log = cuda_build.library_path(name).with_suffix(".log").read_text()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"[build] {name}: " + " | ".join(regs[:12]))
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


def check_decode(gen) -> dict:
    import torch.nn.functional as F

    from transformers_tpu_torch.ops.fused_decode import (fused_decode_attention,
                                                         fused_decode_plain)

    cases = {
        "first_token": dict(s=160, pos=0),
        "left_padded": dict(s=PROMPT + NEW, pos=PROMPT + NEW - 1, starts=list(PADS)),
        "mask_holes": dict(s=160, pos=100, holes=0.2),
        "long_context": dict(s=4096, pos=4000, starts=[0, 100, 511, 512, 0, 7, 1000, 3]),
    }
    result = None
    for name, c in cases.items():
        q, kn, vn, cos, sin, kc, vc, start, valid = _decode_inputs(
            gen, s=c["s"], starts=c.get("starts"), holes=c.get("holes", 0))
        pos = c["pos"]
        scale = q.shape[-1] ** -0.5
        kc2, vc2 = kc.clone(), vc.clone()
        out = fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos, start, valid,
                                     scale=scale)
        ref = fused_decode_plain(q, kn, vn, cos, sin, kc2, vc2, pos, start, valid, scale=scale)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        cache_err = max(max_err(kc, kc2), max_err(vc, vc2))
        print(f"[decode] {name}: max_abs_err out {err:.3e}, caches {cache_err:.3e} "
              f"(tol {KERNEL_ATOL})")
        if err > KERNEL_ATOL or cache_err > KERNEL_ATOL:
            raise AssertionError(f"fused decode kernel disagrees with its plain version ({name})")
        if name != "left_padded":
            continue
        b, _, h, d = q.shape
        kvh, s = kc.shape[1], kc.shape[2]
        ms = device_ms(lambda: fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos, start,
                                                      valid, scale=scale))
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
        result = dict(name="fused_decode", route="cuda",
                      source="transformers_tpu_torch/csrc/fused_decode.cu",
                      replaces="transformers_tpu/ops/pallas/fused_decode.py:326",
                      max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                      library_ms=library_ms)
        print(f"[decode] B={b} S={s} H={h} KVH={kvh} D={d} pos={pos}: {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bms:.4f} ms ({by})")
    return result



def check_reference_cases(gen) -> None:
    """Each kernel against its plain version on the reference's tests/ops
    cases, in float32, float16 and bf16: every build of both kernels (three
    storage types by head_dim 64, 128, 256) runs at least once."""
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
    n_cases = {"flash_fwd": len(FLASH_OPS_CASES), "fused_decode": len(DECODE_OPS_CASES)}
    for (kernel, dtype), err in worst.items():
        print(f"[ops cases] {kernel} {str(dtype).replace('torch.', '')}: max_abs_err "
              f"{err:.3e} over {n_cases[kernel]} cases (tol {TOLERANCE[dtype]})")


# --------------------------------------------------------------------- (c)
def _reset_counts():
    from transformers_tpu_torch.ops.flash_attention import flash_attention
    from transformers_tpu_torch.ops.fused_decode import fused_decode_attention

    flash_attention.launches = 0
    fused_decode_attention.launches = 0


def _read_counts() -> dict:
    from transformers_tpu_torch.ops.flash_attention import flash_attention
    from transformers_tpu_torch.ops.fused_decode import fused_decode_attention

    return {"flash_fwd": flash_attention.launches,
            "fused_decode": fused_decode_attention.launches}


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


def check_generate(seed: int, card: str) -> dict:
    from transformers_tpu_torch import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(**GEOMETRY, max_position_embeddings=PROMPT + NEW, bos_token_id=None,
                      eos_token_id=None, pad_token_id=0)
    layers = cfg.num_hidden_layers
    model = LlamaForCausalLM(cfg, dtype=torch.bfloat16, device="cuda").init_weights(seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ids = torch.randint(1, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device="cuda")
    mask = (torch.arange(PROMPT, device="cuda")[None, :]
            >= torch.tensor(PADS, device="cuda")[:, None]).to(torch.int32)
    ids = ids.masked_fill(mask == 0, 0)
    kw = dict(attention_mask=mask, prompt_pad_multiple=PROMPT)

    model.generate(ids, max_new_tokens=2, **kw)  # warm-up: cuBLAS and kernel libraries
    _reset_counts()
    out = model.generate(ids, max_new_tokens=NEW, **kw)
    torch.cuda.synchronize()
    counts = _read_counts()
    expected = {"flash_fwd": layers, "fused_decode": layers * (NEW - 1)}
    print(f"[generate] launches {counts}, expected {expected} "
          f"({layers} layers, 1 prefill, {NEW - 1} decode steps)")
    if counts != expected:
        raise AssertionError("the main path did not go through the kernels as required")
    if out.shape != (BATCH, PROMPT + NEW) or not torch.equal(out[:, :PROMPT], ids):
        raise AssertionError(f"generate returned {tuple(out.shape)} or changed the prompt")
    if int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError("generated ids outside the vocabulary")

    prefill = sorted(_timed(lambda: model.generate(ids, max_new_tokens=1, **kw))
                     for _ in range(3))[1]
    total = sorted(_timed(lambda: model.generate(ids, max_new_tokens=NEW, **kw))
                   for _ in range(3))[1]
    decode_tok = (total - prefill) / (NEW - 1)
    print(f"[generate] B={BATCH} prompt={PROMPT} new={NEW} bf16, 32 layers: prefill "
          f"{prefill:.2f} ms, decode {decode_tok:.3f} ms/step, "
          f"{BATCH * 1e3 / decode_tok:.1f} decode tokens/s, "
          f"{BATCH * NEW * 1e3 / total:.1f} tokens/s over the whole generate ({card})")

    profile_generate(lambda: model.generate(ids, max_new_tokens=NEW, **kw), total, card)
    teacher_force(model, out, mask)
    return counts


def profile_generate(run, wall_ms: float, card: str) -> None:
    """Device busy time of one generate call from torch.profiler (kernel
    time summed over the call), against the unprofiled wall time; and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0:
        print("[profile] the profiler recorded no device time: busy share not measured")
        return
    print(f"[profile] generate: device busy {busy_ms:.2f} ms of {wall_ms:.2f} ms wall "
          f"(unprofiled), idle share {1 - busy_ms / wall_ms:.3f} ({card})")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
              f"{e.key[:90]}")


def teacher_force(model, seq, prompt_mask) -> None:
    """The generated sequence through the kernel path (prefill of all but the
    last token, then one decode step) and through the plain path (eager
    attention, no cache, no kernel), against the same model in float32 as
    the reference. The kernel path must be no further from float32 than twice
    the plain bf16 path is: both are bf16 through 32 layers, and they round
    at different places (f32 rope in the decode kernel, f32 probabilities in
    both kernels)."""
    from transformers_tpu_torch import LlamaForCausalLM

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
        _reset_counts()
        model.config.attn_implementation = "eager"
        plain_all = model(seq, attention_mask=mask, position_ids=pos).logits
        model.config.attn_implementation = None
        if any(_read_counts().values()):
            raise AssertionError("the plain path launched a kernel")
        plain = plain_all[:, -1].float()
        agree = float((plain_all[:, PROMPT - 1:-1].argmax(-1) == seq[:, PROMPT:]).float().mean())
        del plain_all
        ref_model = LlamaForCausalLM(model.config, dtype=torch.float32, device="cuda")
        ref_model.load_state_dict(model.state_dict())
        ref_model.config.attn_implementation = "eager"
        ref = ref_model(seq, attention_mask=mask, position_ids=pos,
                        logits_to_keep=1).logits[:, -1]
        ref_model.config.attn_implementation = None
        del ref_model
        torch.cuda.empty_cache()
    err_kernel = max_err(kernel, plain)
    err_plain_f32 = max_err(plain, ref)
    err_kernel_f32 = max_err(kernel, ref)
    finite = bool(torch.isfinite(kernel).all())
    print(f"[teacher-force] last-position logits (|max| {float(plain.abs().max()):.3f}): "
          f"|kernel - plain| {err_kernel:.4f}, |plain - f32| {err_plain_f32:.4f}, "
          f"|kernel - f32| {err_kernel_f32:.4f}; greedy tokens = plain argmax at "
          f"{agree:.3f} of generated positions")
    if not finite or err_kernel_f32 > 2 * err_plain_f32:
        raise AssertionError("kernel path logits disagree with the plain path")


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
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    kernels = [check_flash(gen), check_decode(gen)]
    check_reference_cases(gen)
    check_load_path(args.seed, card)
    counts = check_generate(args.seed, card)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
