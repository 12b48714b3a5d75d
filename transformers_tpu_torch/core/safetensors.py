"""Safetensors reader and writer in plain Python, decoding with torch dtypes.

Port of ``transformers_tpu/core/safetensors.py``. The format: an 8-byte
little-endian header size, a JSON header mapping each tensor name to
``{"dtype", "shape", "data_offsets"}``, then one flat byte buffer. Reads are
served from a private copy-on-write ``mmap`` (so ``torch.frombuffer`` gets a
writable buffer without touching the file), and only the tensors asked for
touch memory. bf16, f16 and the fp8 types decode with torch's own dtypes.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Optional

import torch

_DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "F8_E4M3": torch.float8_e4m3fn,
    "F8_E5M2": torch.float8_e5m2,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "U16": torch.uint16,
    "U32": torch.uint32,
    "U64": torch.uint64,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class SafetensorsFile:
    """A lazily mapped safetensors file. Use as a context manager or call close()."""

    def __init__(self, path: str):
        self.path = path
        self._file = open(path, "rb")
        header_size = struct.unpack("<Q", self._file.read(8))[0]
        header = json.loads(self._file.read(header_size))
        self.metadata: dict = header.pop("__metadata__", {})
        self._entries: dict[str, dict] = header
        self._data_start = 8 + header_size
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_COPY)

    def keys(self) -> list[str]:
        return list(self._entries)

    def get_shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def get_tensor(self, name: str) -> torch.Tensor:
        """A CPU tensor viewing the mapping (no copy) for tensor ``name``."""
        entry = self._entries[name]
        dtype = _DTYPES[entry["dtype"]]
        shape = tuple(entry["shape"])
        start, end = entry["data_offsets"]
        if end == start:
            return torch.empty(shape, dtype=dtype)
        buf = memoryview(self._mmap)[self._data_start + start:self._data_start + end]
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)

    def close(self):
        if self._mmap is not None:
            try:
                self._mmap.close()
            except BufferError:
                # tensors still view the mapping; it goes with the last of them
                pass
            self._mmap = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor in a file, as copies that outlive the mapping."""
    with SafetensorsFile(path) as f:
        return {k: f.get_tensor(k).clone() for k in f.keys()}


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: Optional[dict] = None) -> None:
    """Write a safetensors file readable by the Rust implementation. Tensors
    may lie on any device; each is copied to the host as it is written."""
    header: dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"Unsupported dtype {t.dtype} for tensor {name}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    header_bytes += b" " * ((8 - len(header_bytes) % 8) % 8)  # 8-byte alignment
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(header_bytes)))
        f.write(header_bytes)
        for t in tensors.values():
            if t.numel():
                f.write(t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy())
    os.replace(tmp, path)
