#!/usr/bin/env python3
"""Time variants of the tensor-core Q1 (quantized_matmul) and each split of K
on one CUDA card.

    python3 quantized_linear_sweep.py

Builds ``csrc/quantized_linear.cu`` once for each variant of its block shape
and pipeline (``VARIANTS``: -D flags of TTPU_Q1_WARPS, TTPU_Q1_CHUNK,
TTPU_Q1_STAGES, TTPU_Q1_STAGGER; all builds at once) and prints the
default build's tensor-core registers, shared memory and spills. Then, at
the four Llama-3-8B projection shapes of ``chip_smoke.py`` (int8 codes x
bf16, each weight read from device memory as the smoke times it) and each
row count of ``ROWS``, holds every variant at its first split to
``quantized_matmul_split_plain`` (one rounding step, as the smoke holds
it) and times it at each split count of ``SPLIT_COUNTS``. Prints one line
per variant, shape and row count, then each variant's sum over a Llama
layer's seven projections at its fastest splits, and the card's name and
power limit. The defaults in the CUDA source and ``split_size`` in
``ops/quantized_linear.py`` are set from these readings.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as smoke

VARIANTS = {  # name: -D flags (the first: the source's defaults)
    "8 warps, 4 stages, stagger": (),
    "4 warps, 3 stages": ("TTPU_Q1_WARPS=4", "TTPU_Q1_STAGES=3", "TTPU_Q1_STAGGER=0"),
    "4 warps, 3 stages, stagger": ("TTPU_Q1_WARPS=4", "TTPU_Q1_STAGES=3"),
    "4 warps, 2 stages": ("TTPU_Q1_WARPS=4", "TTPU_Q1_STAGES=2", "TTPU_Q1_STAGGER=0"),
    "4 warps, 3 stages, chunk 512, stagger": ("TTPU_Q1_WARPS=4", "TTPU_Q1_STAGES=3",
                                              "TTPU_Q1_CHUNK=512"),
    "4 warps, 2 stages, chunk 512, stagger": ("TTPU_Q1_WARPS=4", "TTPU_Q1_STAGES=2",
                                              "TTPU_Q1_CHUNK=512"),
}
SPLIT_COUNTS = (1, 2, 3, 4, 6, 8, 16)  # splits of K (fewer where K has fewer chunks)
ROWS = (1, 8, 16, 64)


def _chunk(defines) -> int:
    return next((int(d.split("=")[1]) for d in defines if d.startswith("TTPU_Q1_CHUNK=")), 256)


def main() -> int:
    if not torch.cuda.is_available():
        print("quantized_linear_sweep: no CUDA card", file=sys.stderr)
        return 1
    import ctypes

    from transformers_tpu_torch.ops import cuda_build
    from transformers_tpu_torch.ops import quantized_linear as ql

    card = smoke.card_line()
    cuda_build.build(("quantized_linear",), variants=tuple(VARIANTS.values()))
    log = cuda_build.library_path("quantized_linear").with_suffix(".log").read_text()
    for b in smoke.ptxas_builds(log):
        if "quantized_linear_tc_kernel" in b["name"]:
            print(f"[build] {b['name']}: {b['regs']} registers, static smem {b['smem']} bytes, "
                  f"spill bytes {b['spill']}")
    fns = {}
    for name, defines in VARIANTS.items():
        fn = ctypes.CDLL(str(cuda_build.library_path("quantized_linear", defines)))
        fns[name] = fn.ttpu_quantized_linear
        fns[name].argtypes = list(ql._LINEAR_ARGTYPES)
        fns[name].restype = ctypes.c_int
    gen = torch.Generator(device="cuda").manual_seed(0)
    best = {name: {} for name in VARIANTS}
    for n, k in smoke.QUANT_SHAPES:
        codes_list = smoke._cold(lambda i: smoke._quantized_weights(gen, n, k, "int8"), n * k)
        codes, scale = codes_list[0]
        for m in ROWS:
            x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
            bms, _ = smoke.bound_ms(n * k + n * 4 + m * (k + n) * 2, 2.0 * m * n * k)
            for name, defines in VARIANTS.items():
                chunk, fn = _chunk(defines), fns[name]
                chunks = -(-k // chunk)
                splits = sorted({-(-chunks // min(c, chunks)) * chunk for c in SPLIT_COUNTS},
                                reverse=True)
                out = ql.launch_q1(fn, x, codes, scale, k, splits[0], chunk)
                ref = ql.quantized_matmul_split_plain(x, codes, scale, k, splits[0])
                ratio = smoke.grad_ratio(out, ref, smoke.GRAD_ULP[torch.bfloat16])
                if ratio > 1.0:
                    raise AssertionError(f"{name} N={n} K={k} M={m}: grad_ratio {ratio:.3f} "
                                         f"against the split plain version")
                times = [(split, smoke.device_ms(smoke._cycled(
                    lambda cs: ql.launch_q1(fn, x, cs[0], cs[1], k, split, chunk), codes_list)))
                    for split in splits]
                fast = min(times, key=lambda t: t[1])
                best[name][(n, k, m)] = fast[1]
                print(f"[sweep] {name}: N={n} K={k} M={m}, split (K values, splits): ms: "
                      + ", ".join(f"{s} ({-(-k // s)}): {t:.4f}" for s, t in times)
                      + f"; fastest {fast[0]}: {fast[1]:.4f} ms, {bms / fast[1]:.3f} of the "
                      f"bound {bms:.4f} ms; split_size {ql.split_size(n, k)}")
        del codes_list
    for name in VARIANTS:
        layer = [sum(best[name][(n, k, m)] * smoke.QUANT_LAYER_COUNT[(n, k)]
                     for n, k in smoke.QUANT_SHAPES) for m in ROWS]
        print(f"[sweep] {name}: a layer's seven projections at their fastest splits, M: ms: "
              + ", ".join(f"{m}: {t:.4f}" for m, t in zip(ROWS, layer)))
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
