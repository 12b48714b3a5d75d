"""SentencePiece ``.model`` reader — no sentencepiece/protobuf dependency.

A copy of ``transformers_tpu/tokenization/spm.py``: the reference's slow->fast converter chain
(reference convert_slow_tokenizer.py:634 ``SpmConverter``): parse the
ModelProto protobuf wire format directly and emit a tokenizer.json-shaped
config the in-tree engine consumes (Unigram or BPE model + metaspace
normalization). Field numbers follow sentencepiece.proto
(ModelProto: pieces=1, trainer_spec=2, normalizer_spec=3;
SentencePiece: piece=1, score=2, type=3; TrainerSpec: model_type=3,
byte_fallback=35, unk_id=40; NormalizerSpec: add_dummy_prefix=3).
"""

from __future__ import annotations

import struct
from typing import Any, Iterator, Optional


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) from a protobuf message."""
    i = 0
    n = len(buf)
    while i < n:
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, i = _read_varint(buf, i)
        elif wire == 1:  # 64-bit
            val = buf[i : i + 8]
            i += 8
        elif wire == 2:  # length-delimited
            length, i = _read_varint(buf, i)
            val = buf[i : i + length]
            i += length
        elif wire == 5:  # 32-bit
            val = buf[i : i + 4]
            i += 4
        else:
            raise ValueError(f"Unsupported wire type {wire}")
        yield field, wire, val


def parse_spm_model(data: bytes) -> dict:
    """ModelProto -> {"pieces": [(text, score, type)], "model_type",
    "add_dummy_prefix", "byte_fallback", "unk_id", ...}."""
    out: dict[str, Any] = {
        "pieces": [], "model_type": 1, "add_dummy_prefix": True,
        "remove_extra_whitespaces": True, "byte_fallback": False, "unk_id": 0,
        "treat_whitespace_as_suffix": False,
    }
    for field, wire, val in _fields(data):
        if field == 1:  # SentencePiece
            piece, score, ptype = "", 0.0, 1
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    ptype = v2
            out["pieces"].append((piece, score, ptype))
        elif field == 2:  # TrainerSpec
            for f2, w2, v2 in _fields(val):
                if f2 == 3:
                    out["model_type"] = v2  # 1=unigram 2=bpe
                elif f2 == 35:
                    out["byte_fallback"] = bool(v2)
                elif f2 == 40:
                    out["unk_id"] = v2
                elif f2 == 24:
                    out["treat_whitespace_as_suffix"] = bool(v2)
        elif field == 3:  # NormalizerSpec
            for f2, w2, v2 in _fields(val):
                if f2 == 3:
                    out["add_dummy_prefix"] = bool(v2)
                elif f2 == 4:
                    out["remove_extra_whitespaces"] = bool(v2)
    return out


def _bpe_merges_from_pieces(pieces: list[tuple[str, float, int]]) -> list[list[str]]:
    """Recover BPE merges by recombination, ranked by score (the reference's
    SpmConverter BPE extraction approach re-derived)."""
    vocab = {p: i for i, (p, _s, _t) in enumerate(pieces)}
    score = {p: s for (p, s, _t) in pieces}
    merges = []
    for piece, _s, ptype in pieces:
        if ptype != 1 or len(piece) < 2:
            continue
        best = None
        for i in range(1, len(piece)):
            l, r = piece[:i], piece[i:]
            if l in vocab and r in vocab:
                cand = (vocab[l], vocab[r])
                if best is None or cand < best[0]:
                    best = (cand, l, r)
        if best is not None:
            merges.append((vocab[piece], best[1], best[2]))
    merges.sort(key=lambda m: m[0])
    return [[l, r] for _rank, l, r in merges]


def spm_to_tokenizer_config(data: bytes) -> dict:
    """Emit the tokenizer.json-shaped dict our engine loads."""
    spm = parse_spm_model(data)
    pieces = spm["pieces"]
    # CONTROL(3)/UNKNOWN(2) pieces become special added tokens
    added_tokens = [
        {"id": i, "content": p, "special": True}
        for i, (p, _s, t) in enumerate(pieces) if t in (2, 3)
    ]
    normalizers = []
    if spm["add_dummy_prefix"]:
        normalizers.append({"type": "Prepend", "prepend": "▁"})
    normalizers.append({"type": "Replace", "pattern": {"String": " "}, "content": "▁"})
    config: dict[str, Any] = {
        "version": "1.0",
        "normalizer": {"type": "Sequence", "normalizers": normalizers},
        "pre_tokenizer": None,
        "post_processor": None,
        "decoder": {"type": "Metaspace", "replacement": "▁",
                    "add_prefix_space": spm["add_dummy_prefix"]},
        "added_tokens": added_tokens,
    }
    if spm["model_type"] == 2:  # BPE
        vocab = {p: i for i, (p, _s, _t) in enumerate(pieces)}
        config["model"] = {
            "type": "BPE",
            "vocab": vocab,
            "merges": _bpe_merges_from_pieces(pieces),
            "unk_token": pieces[spm["unk_id"]][0] if pieces else "<unk>",
            "byte_fallback": spm["byte_fallback"],
            "fuse_unk": True,
        }
    else:  # Unigram
        config["model"] = {
            "type": "Unigram",
            "vocab": [[p, s] for (p, s, _t) in pieces],
            "unk_id": spm["unk_id"],
            "byte_fallback": spm["byte_fallback"],
        }
    return config
