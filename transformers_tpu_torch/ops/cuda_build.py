"""Build and load the port's CUDA kernels (``transformers_tpu_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with ``nvcc``
for ``sm_90a`` into its own shared library under ``transformers_tpu_torch/_build``
(listed in ``.gitignore``) at first use, and loaded with ``ctypes``. The
library's file name carries a hash of the sources and flags, so an edited
source is rebuilt and a stale build is never loaded. Nothing is built or
loaded when this module is imported: the CPU tests import every module on a
machine without ``nvcc``.

Each kernel wrapper counts its launches in its ``launches`` attribute
(``counted``). A captured CUDA graph runs no Python when it is replayed, so
``CountedGraph`` keeps those counts exact under replay: a capture's rise is
taken back and added again at every replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
KERNELS = ("flash_fwd", "flash_bwd", "fused_decode", "paged_decode", "quantized_linear")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kept in step with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [str(Path(home) / "bin" / "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (named by a hash of what goes in)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=KERNELS) -> None:
    """Compile the named kernels that are not built yet, one ``nvcc`` each,
    all started together. ``nvcc``'s register and shared-memory report is
    kept beside each library as ``.log``. Raises with the compiler's output
    when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it on first use."""
    build((name,))
    return ctypes.CDLL(str(library_path(name)))


@functools.cache
def kernel_fn(name: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of kernel library ``name``, with its argument
    types set (``c_void_p`` for pointers and the stream) and an int result."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_COUNTED: list = []  # the kernel wrappers, each counting its launches in ``launches``


def counted(wrapper):
    """Register ``wrapper``, whose ``launches`` attribute (set to 0 here) it
    raises by one where it launches its kernel."""
    wrapper.launches = 0
    _COUNTED.append(wrapper)
    return wrapper


class CountedGraph:
    """A CUDA graph whose replays keep the wrappers' launch counts exact.

    A capture runs each wrapper's Python once and launches nothing; a replay
    launches the captured kernels and runs no Python. So ``capture`` records
    how far each count rose while capturing and takes that back, and
    ``replay`` adds it at every replay. ``generator``: a CUDA generator whose
    draws the graph captures (registered before the capture; each replay
    advances it as the eager calls would)."""

    def __init__(self, generator: Optional[torch.Generator] = None):
        self.graph = torch.cuda.CUDAGraph()
        if generator is not None:
            self.graph.register_generator_state(generator)
        self.launches: dict = {}  # wrapper -> launches of one replay
        self.capture_ms: Optional[float] = None  # host time of the capture

    @contextlib.contextmanager
    def capture(self, stream: Optional[torch.cuda.Stream] = None):
        before = [w.launches for w in _COUNTED]
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                yield
        finally:
            self.capture_ms = (time.perf_counter() - t0) * 1e3
            for w, n in zip(_COUNTED, before):
                if w.launches != n:
                    self.launches[w] = w.launches - n
                    w.launches = n

    def capture_after_run(self, run, captured=None) -> tuple:
        """``run()`` for real on a side stream, so that what a first call sets
        up (cuBLAS workspaces, kernel libraries, the decode kernels' tickets)
        exists before the capture; then ``captured()`` (``run`` by default)
        captured on that stream. Returns (``run()``'s result, the captured
        call's result: the graph's output, written by each replay)."""
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            result = run()
        torch.cuda.current_stream().wait_stream(side)
        with self.capture(stream=side):
            out = (captured or run)()
        return result, out

    def replay(self) -> None:
        self.graph.replay()
        for w, n in self.launches.items():
            w.launches += n


def read_back(t: torch.Tensor) -> torch.Tensor:
    """``t`` on the host: a decode loop's deliberate read. On the card, a copy
    into pinned memory on the current stream and a wait on an event recorded
    after it. ``torch.cuda.set_sync_debug_mode`` flags stream and device
    synchronisations and copies to pageable memory, not this wait, so under
    that mode a loop's reads other than these raise. Counted in
    ``read_back.reads``."""
    read_back.reads += 1
    if t.device.type != "cuda":
        return t.clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    done.synchronize()
    return host


read_back.reads = 0

_TICKETS: dict = {}  # device -> the decode kernels' ticket buffer
_RETIRED: list = []  # outgrown ticket buffers, kept: a captured graph may still point at one


def tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 tickets on ``device``, all 0, for the split-KV
    decode kernels (K2, K7): the last block of a (row, kv head) to finish
    finds out through its ticket and sets it back to 0, so the buffer is 0
    between calls and one buffer serves every call on the device's stream
    (calls on two streams of one device at once would share tickets: the
    port makes none). Allocated, zeroed, at a call outside CUDA graph
    capture; a graph replays against the buffer it captured."""
    buf = _TICKETS.get(device)
    if buf is None or buf.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the decode kernels' tickets are allocated at a first call "
                               "outside CUDA graph capture, at least this batch size")
        if buf is not None:
            _RETIRED.append(buf)
        buf = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _TICKETS[device] = buf
    return buf


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(tensors: dict, dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless every tensor lies on ``device``, is contiguous, and is 16-byte
    aligned (the kernels use vector loads); ``dtype`` applies to the
    floating-point tensors."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.is_floating_point() and t.dtype != dtype:
            raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def refuse_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through a kernel that has no
    backward (the Pallas kernel has no VJP either): an output cut off from
    the graph would silently drop it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no backward; call it under torch.no_grad() "
                           f"or torch.inference_mode()")


def raise_on_error(code: int, kernel: str) -> None:
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {code}")
