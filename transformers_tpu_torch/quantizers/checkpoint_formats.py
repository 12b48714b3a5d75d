"""Pre-quantized hub checkpoint consumption — GPTQ / AWQ / compressed-tensors
/ fp8 / bitsandbytes / HQQ / BitNet readers that dequantize packed weights
into plain torch-layout float weights.

The port's own copy of ``transformers_tpu/quantizers/checkpoint_formats.py``
(numpy, as there), so that the port imports nothing of the JAX package.
Reference parity: src/transformers/quantizers/ (quantizer_gptq.py,
quantizer_awq.py, quantizer_compressed_tensors.py, quantizer_finegrained_fp8.py)
+ utils/quantization_config.py. Dequantize-on-load: the packed integer tensors
are expanded on the host and the usual loader takes over, so every model
family works with every format; a loaded model can then be quantized to the
port's runtime formats (weight-only int8 / int4 / fp8, ``quantizers/weight_only.py``)
for serving. The readers take numpy arrays; ``dequantize_state_dict`` also
takes the torch tensors the port's safetensors reader gives (bf16 and fp8
widened exactly to float32 on the way), so the port needs no ``ml_dtypes``.

Packed layouts implemented here (verified against scalar transcriptions of
the packing code in tests/quantization/test_prequantized_checkpoints.py):

- GPTQ (AutoGPTQ "gptq" format, bits=4/8):
  qweight int32 [K/pack, N] packed along K, qzeros int32 [G, N/pack],
  scales f16 [G, N], g_idx int32 [K]. w[k,n] = s[g_idx[k],n] *
  (q[k,n] - z[g_idx[k],n] - 1)  (the legacy +1 zero offset; the "gptq_v2"
  checkpoint_format drops it). Dequant result is [K, N] = torch-weight.T.
- AWQ (gemm format, bits=4): qweight int32 [K, N/8] with the AWQ nibble
  interleave [0,2,4,6,1,3,5,7], qzeros same packing, scales f16 [G, N].
  w[k,n] = s[g,n] * (q[k,n] - z[g,n]); result [K, N] = torch-weight.T.
- compressed-tensors (pack-quantized int4/int8): weight_packed int32
  [N, K/pack] packed little-endian along K with SIGNED values,
  weight_scale [N, G or 1], optional weight_zero_point. w[n,k] =
  s[n, k//gs] * (q[n,k] - z). Result [N, K] = torch layout.
- fp8 (finegrained / per-tensor): weight float8_e4m3fn [N, K] with either
  weight_scale (per-tensor / per-channel [N,1]) or weight_scale_inv
  [ceil(N/bs), ceil(K/bs)] (DeepSeek 128x128 block quant).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _is_fp8(val) -> bool:
    """A float8 tensor or array (torch's dtypes, or ml_dtypes' in numpy)."""
    return "float8" in str(val.dtype)


def _np(val) -> np.ndarray:
    """A numpy view of a checkpoint tensor: torch tensors are read on the host,
    and the floating types numpy lacks (bf16, the fp8 types) widen exactly to
    float32; numpy arrays pass as they are."""
    if isinstance(val, np.ndarray) or not hasattr(val, "numpy"):
        return val
    val = val.detach().cpu()
    if val.is_floating_point() and val.dtype not in (torch.float16, torch.float32,
                                                     torch.float64):
        val = val.float()
    return val.numpy()


def detect_prequantized(config_qdict: Optional[dict]) -> Optional[str]:
    """Map a config.json ``quantization_config`` dict to a reader name."""
    if not config_qdict:
        return None
    method = config_qdict.get("quant_method")
    if method in ("gptq", "awq", "fp8", "finegrained_fp8", "fbgemm_fp8"):
        return "fp8" if method != "gptq" and method != "awq" else method
    if method == "compressed-tensors":
        return "compressed-tensors"
    if method == "bitsandbytes":
        return ("bitsandbytes_4bit" if config_qdict.get("load_in_4bit")
                or config_qdict.get("_load_in_4bit") else "bitsandbytes_8bit")
    if method == "hqq":
        return "hqq"
    if method == "bitnet":
        return "bitnet"
    return None


# ----------------------------------------------------------------- unpacking

def _unpack_rows(packed: np.ndarray, bits: int) -> np.ndarray:
    """int32 [R/pack, C] -> uint [R, C], values packed along axis 0
    little-endian (GPTQ qweight layout)."""
    pack = 32 // bits
    mask = (1 << bits) - 1
    u = packed.view(np.uint32)
    shifts = (np.arange(pack, dtype=np.uint32) * bits)[None, :, None]
    out = (u[:, None, :] >> shifts) & mask
    return out.reshape(-1, packed.shape[1])


def _unpack_cols(packed: np.ndarray, bits: int, order: Optional[list] = None) -> np.ndarray:
    """int32 [R, C/pack] -> uint [R, C], values packed along axis 1.
    ``order`` maps storage-slot -> logical column offset (AWQ interleave)."""
    pack = 32 // bits
    mask = (1 << bits) - 1
    u = packed.view(np.uint32)
    shifts = (np.arange(pack, dtype=np.uint32) * bits)[None, None, :]
    vals = (u[:, :, None] >> shifts) & mask  # [R, C/pack, pack] in storage order
    if order is not None:
        logical = np.empty(pack, np.int64)
        for slot, col in enumerate(order):
            logical[col] = slot
        vals = vals[:, :, logical]
    return vals.reshape(packed.shape[0], -1)


AWQ_ORDER = [0, 2, 4, 6, 1, 3, 5, 7]


# ------------------------------------------------------------------ dequants

def dequant_gptq(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """GPTQ qweight/qzeros/scales/g_idx -> torch-layout [out, in] float32."""
    bits = int(qcfg.get("bits", 4))
    qweight, qzeros, scales = group["qweight"], group["qzeros"], group["scales"]
    K = qweight.shape[0] * (32 // bits)
    g_idx = group.get("g_idx")
    if g_idx is None:
        gs = int(qcfg.get("group_size", 128))
        gs = K if gs in (-1, 0) else gs
        g_idx = np.arange(K) // gs
    g_idx = np.asarray(g_idx, np.int64)
    w = _unpack_rows(qweight, bits).astype(np.int32)          # [K, N]
    z = _unpack_cols(qzeros, bits).astype(np.int32)           # [G, N]
    if qcfg.get("checkpoint_format", "gptq") != "gptq_v2" and not qcfg.get("sym_no_offset"):
        z = z + 1
    s = scales.astype(np.float32)                             # [G, N]
    deq = s[g_idx] * (w - z[g_idx])                           # [K, N]
    return np.ascontiguousarray(deq.T)                        # torch [N, K]


def dequant_awq(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """AWQ gemm qweight/qzeros/scales -> torch-layout [out, in] float32."""
    bits = int(qcfg.get("bits", 4))
    qweight, qzeros, scales = group["qweight"], group["qzeros"], group["scales"]
    gs = int(qcfg.get("group_size", 128))
    K = qweight.shape[0]
    gs = K if gs in (-1, 0) else gs
    w = _unpack_cols(qweight, bits, AWQ_ORDER).astype(np.int32)   # [K, N]
    z = _unpack_cols(qzeros, bits, AWQ_ORDER).astype(np.int32)    # [G, N]
    s = scales.astype(np.float32)                                 # [G, N]
    g_idx = np.arange(K) // gs
    deq = s[g_idx] * (w - z[g_idx])
    return np.ascontiguousarray(deq.T)


def dequant_compressed_int(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """compressed-tensors pack-quantized -> torch-layout [out, in] float32."""
    packed = group["weight_packed"]
    scale = group["weight_scale"].astype(np.float32)
    bits = int(qcfg.get("num_bits", 4))
    pack = 32 // bits
    shape = group.get("weight_shape")
    N = packed.shape[0]
    K = int(shape[1]) if shape is not None else packed.shape[1] * pack
    vals = _unpack_cols(packed, bits)[:, :K].astype(np.int32)     # [N, K] unsigned
    # stored values are signed two's-complement nibbles
    vals = np.where(vals >= (1 << (bits - 1)), vals - (1 << bits), vals)
    zp = group.get("weight_zero_point")
    if zp is not None:
        vals = vals - zp.astype(np.int32).reshape(N, -1)
    if scale.ndim == 0 or scale.size == 1:
        return scale.reshape(()) * vals
    scale = scale.reshape(N, -1)                                   # [N, G]
    G = scale.shape[1]
    gs = -(-K // G)
    g_idx = np.arange(K) // gs
    return scale[:, g_idx] * vals


def dequant_fp8(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """fp8 weight (+ weight_scale | weight_scale_inv) -> [out, in] float32."""
    w = group["weight"].astype(np.float32)                        # [N, K]
    if "weight_scale_inv" in group:  # DeepSeek block quant
        s = group["weight_scale_inv"].astype(np.float32)
        bs = int(qcfg.get("weight_block_size", [128, 128])[0])
        n_idx = np.arange(w.shape[0]) // bs
        k_idx = np.arange(w.shape[1]) // bs
        return w * s[np.ix_(n_idx, k_idx)]
    s = group.get("weight_scale")
    if s is None:
        return w
    s = s.astype(np.float32)
    if s.size == 1:
        return w * s.reshape(())
    return w * s.reshape(-1, 1)                                   # per-channel


NF4_TABLE = np.asarray([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], np.float32)


def dequant_bnb_4bit(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """bitsandbytes 4-bit (nf4/fp4, reference quantizer_bnb_4bit.py:179 +
    bnb.functional.dequantize_4bit): ``weight`` is the nibble-packed codes
    [numel/2, 1] uint8 (first value in the HIGH nibble), ``quant_map`` the
    16-entry code table, ``absmax`` the per-``blocksize`` scales — possibly
    double-quantized (int8 codes dequantized through ``nested_quant_map`` x
    ``nested_absmax`` + ``nested_offset``)."""
    import json

    state_key = next(k for k in group if k.startswith("quant_state"))
    meta = json.loads(bytes(np.asarray(group[state_key]).tolist()))
    shape = meta["shape"]
    blocksize = int(meta.get("blocksize", 64))
    packed = np.asarray(group["weight"]).reshape(-1)
    codes = np.empty(packed.size * 2, np.uint8)
    codes[0::2] = packed >> 4
    codes[1::2] = packed & 0xF
    qmap = np.asarray(group.get("quant_map", NF4_TABLE), np.float32)
    vals = qmap[codes]
    absmax = np.asarray(group["absmax"])
    if "nested_absmax" in group:
        # double quantization: absmax stored as int8 codes over a dynamic map
        nmap = np.asarray(group["nested_quant_map"], np.float32)
        nabs = np.asarray(group["nested_absmax"], np.float32)
        nbs = int(meta.get("nested_blocksize", 256))
        offset = float(meta.get("nested_offset", 0.0))
        deq = nmap[np.asarray(absmax, np.uint8).astype(np.int64) & 0xFF]
        blocks = np.repeat(nabs, nbs)[: deq.size]
        absmax = deq * blocks + offset
    absmax = np.asarray(absmax, np.float32)
    n = int(np.prod(shape))
    scales = np.repeat(absmax, blocksize)[:n]
    return (vals[:n] * scales).reshape(shape).astype(np.float32)


def dequant_bnb_8bit(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """bitsandbytes LLM.int8: ``weight`` int8 [out, in] + per-row ``SCB``
    absmax scales; w = int8 * SCB / 127 (reference integrations/
    bitsandbytes.py:265)."""
    w = np.asarray(group["weight"], np.float32)
    scb = np.asarray(group["SCB"], np.float32)
    return w * scb.reshape(-1, 1) * (1.0 / 127.0)


def dequant_hqq(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """HQQ (reference quantizer_hqq.py; hqq.core.quantize.Quantizer):
    ``W_q`` nibble-packed (4-bit, high nibble first along axis 0) or raw
    int8, with per-group ``scale``/``zero``; w = (q - zero) * scale over
    group_size slices along ``axis``."""
    import json

    meta = group.get("meta")
    if meta is not None and meta.dtype == np.uint8:
        meta = json.loads(bytes(np.asarray(meta).tolist()))
    elif not isinstance(meta, dict):
        meta = {k: v for k, v in qcfg.items()}
    wq = np.asarray(group["W_q"])
    bits = int(meta.get("nbits", 4))
    shape = meta.get("shape")
    if bits == 4:
        # hqq BitPack.pack_4bit_u8: the FIRST half of the rows rides the
        # high nibble, the second half the low nibble (stacked, not
        # interleaved)
        q = np.concatenate([wq >> 4, wq & 0xF], axis=0).astype(np.uint8)
    else:
        q = wq.astype(np.int16) if wq.dtype == np.int8 else wq
    scale = np.asarray(group["scale"], np.float32)
    zero = np.asarray(group["zero"], np.float32)
    axis = int(meta.get("axis", 0))
    gs = meta.get("group_size")
    q = q.astype(np.float32)
    if gs:
        gs = int(gs)
        # grouped layout: [n_groups*group_size, cols] viewed as groups along
        # axis 0 (hqq reshapes W to [-1, group_size] when axis=1)
        if axis == 1:
            flat = q.reshape(-1, gs)
            out = (flat - zero.reshape(-1, 1)) * scale.reshape(-1, 1)
            return out.reshape(shape).astype(np.float32)
        flat = q.reshape(gs, -1)
        out = (flat - zero.reshape(1, -1)) * scale.reshape(1, -1)
        return out.reshape(shape).astype(np.float32)
    return ((q - zero) * scale).reshape(shape).astype(np.float32)


def dequant_bitnet(group: dict[str, np.ndarray], qcfg: dict) -> np.ndarray:
    """BitNet b1.58 (reference integrations/bitnet.py unpack_weights):
    ternary {-1, 0, +1} values stored +1 ({0,1,2}) four per uint8 along
    dim 0, dequantized by the per-tensor ``weight_scale``."""
    packed = np.asarray(group["weight"], np.uint8)
    scale = float(np.asarray(group["weight_scale"]).reshape(()))
    rows = packed.shape[0]
    out = np.empty((rows * 4,) + packed.shape[1:], np.float32)
    for i in range(4):
        out[i * rows:(i + 1) * rows] = ((packed >> (2 * i)) & 0b11).astype(np.float32) - 1.0
    return out / scale


_GROUP_SUFFIXES = {
    "gptq": ("qweight", "qzeros", "scales", "g_idx"),
    "awq": ("qweight", "qzeros", "scales"),
    "compressed-tensors": ("weight_packed", "weight_scale", "weight_zero_point",
                           "weight_shape", "weight_global_scale"),
    "fp8": ("weight_scale", "weight_scale_inv"),
    "bitsandbytes_8bit": ("SCB", "weight_format"),
    "hqq": ("W_q", "scale", "zero", "meta"),
    "bitnet": ("weight_scale",),
}

_DEQUANT = {
    "gptq": dequant_gptq,
    "awq": dequant_awq,
    "compressed-tensors": dequant_compressed_int,
}


def _dequantize_bnb4(tensors, qdict):
    """bnb 4-bit shards nest the aux tensors UNDER the weight key
    (``...weight.absmax``, ``...weight.quant_state.bitsandbytes__nf4``)."""
    out = {}
    groups = {}
    weight_keys = {k.rsplit(".quant_state", 1)[0] for k in tensors
                   if ".quant_state." in k}
    for key, val in tensors.items():
        owner = next((w for w in weight_keys
                      if key == w or key.startswith(w + ".")), None)
        if owner is None:
            out[key] = val
        elif key == owner:
            groups.setdefault(owner, {})["weight"] = _np(val)
        else:
            groups.setdefault(owner, {})[key[len(owner) + 1:]] = _np(val)
    for owner, group in groups.items():
        out[owner] = dequant_bnb_4bit(group, qdict)
    return out


def dequantize_state_dict(tensors: dict, qdict: dict) -> dict:
    """Convert a pre-quantized checkpoint state dict (torch tensors or numpy
    arrays) into plain torch-layout float weights, as float32 numpy arrays.
    Non-quantized tensors pass through unchanged."""
    method = detect_prequantized(qdict) or qdict.get("quant_method")
    if method == "bitsandbytes_4bit":
        return _dequantize_bnb4(tensors, qdict)
    suffixes = _GROUP_SUFFIXES[method]
    out: dict[str, np.ndarray] = {}
    groups: dict[str, dict[str, np.ndarray]] = {}
    scb_owners = ({k.rpartition(".")[0] for k in tensors
                   if k.endswith(".SCB")}
                  if method == "bitsandbytes_8bit" else set())
    scale_owners = ({k.rpartition(".")[0] for k in tensors
                     if k.endswith(".weight_scale")}
                    if method == "bitnet" else set())
    for key, val in tensors.items():
        prefix, _, leaf = key.rpartition(".")
        if leaf in suffixes:
            groups.setdefault(prefix, {})[leaf] = _np(val)
        elif method == "fp8" and leaf == "weight" and _is_fp8(val):
            groups.setdefault(prefix, {})["weight"] = _np(val)
        elif leaf == "weight" and prefix in scb_owners:
            groups.setdefault(prefix, {})["weight"] = _np(val)
        elif leaf == "weight" and prefix in scale_owners and _np(val).dtype == np.uint8:
            groups.setdefault(prefix, {})["weight"] = _np(val)
        else:
            out[key] = val

    # compressed-tensors nests per-group config under config_groups
    qcfg = qdict
    if method == "compressed-tensors":
        cg = qdict.get("config_groups") or {}
        if cg:
            first = next(iter(cg.values()))
            qcfg = {**qdict, **(first.get("weights") or {})}

    for prefix, group in groups.items():
        if method == "fp8":
            out[prefix + ".weight"] = dequant_fp8(group, qcfg)
        elif method == "bitsandbytes_8bit" and "SCB" in group:
            out[prefix + ".weight"] = dequant_bnb_8bit(group, qcfg)
        elif method == "hqq" and "W_q" in group:
            out[prefix + ".weight"] = dequant_hqq(group, qcfg)
        elif method == "bitnet" and "weight_scale" in group:
            out[prefix + ".weight"] = dequant_bitnet(group, qcfg)
        elif "qweight" in group or "weight_packed" in group:
            out[prefix + ".weight"] = _DEQUANT[method](group, qcfg)
        else:
            # stray suffix tensors without a packed weight: pass through
            for leaf, val in group.items():
                out[f"{prefix}.{leaf}"] = val
    return out


def load_prequantized_checkpoint(checkpoint_files: list, qdict: dict) -> dict:
    """Read every tensor from the shard files and dequantize the packed ones."""
    from ..core.loading import open_checkpoint_source

    tensors: dict = {}
    for file in checkpoint_files:
        with open_checkpoint_source(file) as f:
            for key in f.keys():
                tensors[key] = f.get_tensor(key).clone()
    return dequantize_state_dict(tensors, qdict)
