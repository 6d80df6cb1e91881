"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into its own shared library with a plain C interface, loaded with
``ctypes``.  Builds happen at the first CUDA use, never at import: all
sources that lack a library are compiled together, one ``nvcc`` process
each.  Libraries are cached under ``_build/`` beside this file (listed in
``.gitignore``), keyed by a hash of the source, the shared header and the
flags.

The flags leave out ``--use_fast_math`` on purpose: IEEE division and
square root keep the keep test ``norms >= thr`` and the quantization
level indices equal to the reference's.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from repro_torch.telemetry import wallclock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("sparsify", "quantize", "fused_compress", "aio_agg")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_FUNCS: dict[tuple[str, str], object] = {}
#: compiler output of the builds this process ran (ptxas register and
#: shared-memory report), by source name
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH): the port's CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> list[str]:
    """Compile every source whose library is not cached, all at once.

    Returns the names that were compiled; raises with the compiler's
    output if any build fails."""
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return todo


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        with wallclock.span("setup.kernels"):
            build_all()
            lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(source: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of ``source``'s library, with its
    argument types declared (every pointer and the stream as
    ``c_void_p``); it returns a CUDA error code."""
    fn = _FUNCS.get((source, symbol))
    if fn is None:
        fn = getattr(_library(source), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[(source, symbol)] = fn
    return fn


def check(source: str, symbol: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = _library(source).repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{symbol}: CUDA error {code} at launch: {msg}")


# ---------------------------------------------------------- lean launch path
#
# The redesigned wrappers (``aio_merge``, the norms) cost the host less
# than their kernels cost the device: one pass of direct checks, no
# ``torch.cuda.device`` context unless the operands lie on another device
# than the current one, the raw stream handle without a ``torch.cuda.Stream``
# object, and a C entry resolved once.

def current_stream(index: int) -> int:
    """The ``cudaStream_t`` of device ``index``'s current stream."""
    return torch._C._cuda_getCurrentRawStream(index)


def f32_vectors(kernel: str, n: int, *planes: torch.Tensor) -> int:
    """Check that every plane is a contiguous float32 ``(n,)`` vector on
    one CUDA device; return that device's index."""
    index = planes[0].get_device()
    for t in planes:
        if t.get_device() != index or index < 0:
            raise ValueError(f"{kernel}: every operand must lie on one CUDA "
                             f"device; got {[str(p.device) for p in planes]}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: operands must be float32; got "
                            f"{t.dtype}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous ({n},) "
                             f"vectors; got shape {tuple(t.shape)}, strides "
                             f"{t.stride()}")
    return index


class Entry:
    """One C entry point, resolved at its first launch and kept.

    ``launch(index, *args)`` calls it with ``args`` and the current stream
    of device ``index``, entering that device only when it is not the
    current one, and raises on a CUDA error."""

    __slots__ = ("source", "symbol", "argtypes", "_fn")

    def __init__(self, source: str, symbol: str, argtypes: tuple):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self._fn = None

    def launch(self, index: int, *args) -> None:
        fn = self._fn
        if fn is None:
            fn = self._fn = function(self.source, self.symbol,
                                     (*self.argtypes, ctypes.c_void_p))
        if index == torch.cuda.current_device():
            code = fn(*args, current_stream(index))
        else:
            with torch.cuda.device(index):
                code = fn(*args, current_stream(index))
        if code:
            check(self.source, self.symbol, code)
