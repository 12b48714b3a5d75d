#!/usr/bin/env python3
"""Time the split-KV decode kernels at each split size on one CUDA card.

    python3 decode_split_sweep.py

The fused decode (K2) at the generate shape of ``chip_smoke.py`` (8 rows,
S = 160, pos = 159, its left pads, 32 query heads over 8 kv heads, head_dim
128, bf16) and the static-cache decode (K7) at the smoke's shape (8 rows, a
BSHD cache of 224 slots, ragged [start, end)), each held to its plain
version and timed as the smoke times it, at every split size below; K2 also
at the smoke's long context (S = 4096, pos = 4000), for what a size costs
there. The wrappers' ``SPLIT_SLOTS`` constants are set for the sweep only:
the port splits at the fastest size, fixed in ``ops/fused_decode.py`` and
``ops/decode_attention.py``. Prints one line per reading and the card's name
and power limit.
"""

from __future__ import annotations

import sys

import torch

import chip_smoke as smoke

SPLITS = (16, 32, 64, 96, 128, 160, 224, 256, 512)


def main() -> int:
    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA card", file=sys.stderr)
        return 1
    from transformers_tpu_torch.ops import cuda_build
    from transformers_tpu_torch.ops import decode_attention as k7
    from transformers_tpu_torch.ops import fused_decode as k2

    card = smoke.card_line()
    cuda_build.build(("fused_decode",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, kn, vn, cos, sin, kc, vc, start, valid = smoke._decode_inputs(
        gen, s=smoke.PROMPT + smoke.NEW, starts=list(smoke.PADS))
    pos = torch.full((1,), smoke.PROMPT + smoke.NEW - 1, dtype=torch.int32, device="cuda")
    scale = q.shape[-1] ** -0.5
    b, s = smoke.BATCH, 224
    starts = torch.randint(0, 40, (b,), generator=gen, device="cuda").tolist()
    ends = torch.randint(150, s + 1, (b,), generator=gen, device="cuda").tolist()
    sq, sk, sv, st, en = smoke._static_inputs(gen, b=b, s=s, h=32, kvh=8, d=128, starts=starts,
                                              ends=ends)
    ref2 = k2.fused_decode_plain(q, kn, vn, cos, sin, kc.clone(), vc.clone(), int(pos), start,
                                 valid, scale=scale)
    ref7 = k7.decode_attention_plain(sq, sk, sv, st, en, scale=scale)
    long = smoke._decode_inputs(gen, s=4096, starts=[0, 100, 511, 512, 0, 7, 1000, 3])
    pos_long = torch.full((1,), 4000, dtype=torch.int32, device="cuda")
    for split in SPLITS:
        k2.SPLIT_SLOTS = k7.SPLIT_SLOTS = split
        out2 = k2.fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos, start, valid,
                                         scale=scale)
        out7 = k7.decode_attention(sq, sk, sv, st, en, scale=scale)
        err = max(smoke.max_err(out2, ref2), smoke.max_err(out7, ref7))
        if err > smoke.KERNEL_ATOL:
            raise AssertionError(f"split {split}: a kernel disagrees with its plain version")
        ms2 = smoke.device_ms(lambda: k2.fused_decode_attention(q, kn, vn, cos, sin, kc, vc, pos,
                                                                start, valid, scale=scale))
        ms7 = smoke.device_ms(lambda: k7.decode_attention(sq, sk, sv, st, en, scale=scale))
        ms_long = smoke.device_ms(lambda: k2.fused_decode_attention(*long[:7], pos_long,
                                                                    *long[7:], scale=scale))
        print(f"[sweep] split {split} slots: K2 {ms2:.4f} ms, K7 {ms7:.4f} ms; K2 at S = 4096, "
              f"pos = 4000: {ms_long:.4f} ms (max_abs_err {err:.3e})")
    print(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
