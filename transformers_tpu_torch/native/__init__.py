"""Host C++ code of the port (port of ``transformers_tpu/native``).

``csrc/bpe.cpp`` is the tokenizer's BPE merge loop over token ids, a
priority queue of adjacent pairs instead of the Python loop's rescan after
every merge. It is compiled with ``g++ -O3`` at first use into
``transformers_tpu_torch/_build`` (listed in ``.gitignore``), under a name
that carries a hash of the source and flags, and bound with ``ctypes``.
Nothing is built when this module is imported. A failed build raises; the
tokenizer does not fall back to Python.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "bpe.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)


def library_path() -> Path:
    h = hashlib.sha1(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libbpe-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile ``csrc/bpe.cpp`` unless it is built; raises with the compiler's
    output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the tokenizer's C++ BPE cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                          text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"C++ BPE build failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process may build the same file
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The built library, building it on first use."""
    lib = ctypes.CDLL(str(build()))
    lib.ttpu_bpe_create.restype = ctypes.c_void_p
    lib.ttpu_bpe_create.argtypes = [_I32P, _I32P, _I32P, ctypes.c_int32]
    lib.ttpu_bpe_free.restype = None
    lib.ttpu_bpe_free.argtypes = [ctypes.c_void_p]
    lib.ttpu_bpe_encode.restype = ctypes.c_int32
    lib.ttpu_bpe_encode.argtypes = [ctypes.c_void_p, _I32P, ctypes.c_int32, _I32P]
    return lib


class NativeBPE:
    """id-space BPE encoder over the C++ library."""

    def __init__(self, merges: list[tuple[int, int, int]]):
        """merges: ordered (left_id, right_id, merged_id)."""
        self._lib = load()
        arr = np.asarray(merges, dtype=np.int32).reshape(len(merges), 3)
        lefts, rights, merged = (np.ascontiguousarray(arr[:, i]) for i in range(3))
        self._handle = self._lib.ttpu_bpe_create(
            lefts.ctypes.data_as(_I32P), rights.ctypes.data_as(_I32P),
            merged.ctypes.data_as(_I32P), len(merges))

    def encode(self, ids: list[int]) -> list[int]:
        n = len(ids)
        if n <= 1:
            return list(ids)
        inp = np.asarray(ids, np.int32)
        out = np.empty(n, np.int32)
        count = self._lib.ttpu_bpe_encode(self._handle, inp.ctypes.data_as(_I32P), n,
                                          out.ctypes.data_as(_I32P))
        return out[:count].tolist()

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ttpu_bpe_free(handle)
