"""Hopper kernels: kernel-wise sparsification (Eq. 2).

Wrappers over ``csrc/sparsify.cu``, which replaces the reference's
``kernel_sumsq``, ``kernel_l2`` and ``threshold_apply``
(``repro/kernels/sparsify.py``).  The norms take a ``(K, ksize)`` float32
CUDA view with any strides; the main path passes each leaf's C-order
buffer as its transpose, strides ``(1, K)``, without a copy.
``threshold_apply`` takes the same view, dense.  The CPU route is
``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_compress import kernel_fastest

#: launches of the CUDA kernels: ``kernel_sumsq`` counts every launch of
#: the norm kernel, ``kernel_l2`` those with the sqrt epilogue
launches = {"kernel_sumsq": 0, "kernel_l2": 0, "threshold_apply": 0}

_SYMBOL = "kernel_sumsq_f32"
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)
_THR_SYMBOL = "threshold_apply_f32"
_THR_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


def _launch(x: torch.Tensor, take_sqrt: bool) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"kernel_sumsq launches on CUDA tensors; got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"kernel_sumsq takes float32; got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"kernel_sumsq takes a (K, ksize) view; got "
                         f"shape {tuple(x.shape)}")
    K, C = x.shape
    out = torch.empty(K, dtype=torch.float32, device=x.device)
    if K == 0:
        return out
    fn = build.function("sparsify", _SYMBOL, _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), out.data_ptr(), K, C, x.stride(0),
                  x.stride(1), int(take_sqrt), stream)
    build.check("sparsify", _SYMBOL, code)
    launches["kernel_sumsq"] += 1
    if take_sqrt:
        launches["kernel_l2"] += 1
    return out


def kernel_sumsq(x: torch.Tensor) -> torch.Tensor:
    """x: (K, ksize) float32 CUDA view -> row sums of squares (K,)."""
    return _launch(x, take_sqrt=False)


def kernel_l2(x: torch.Tensor) -> torch.Tensor:
    """x: (K, ksize) float32 CUDA view -> row L2 norms (K,)."""
    return _launch(x, take_sqrt=True)


def threshold_apply(x: torch.Tensor, norms: torch.Tensor, thr: float,
                    out: Optional[torch.Tensor] = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: dense (K, ksize) float32 CUDA view; norms (K,); thr a float32
    value.  Returns (x * (norms >= thr) per row, laid out like x; the
    float32 keep vector (K,)).  ``out``, when given, is a view with x's
    shape and strides that receives the first result (the main path
    hands each leaf its slot of one flat buffer)."""
    for name, t in (("x", x), ("norms", norms)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"threshold_apply: {name} must be on "
                             f"{x.device} (CUDA); got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"threshold_apply: {name} must be float32; "
                            f"got {t.dtype}")
    if x.dim() != 2:
        raise ValueError(f"threshold_apply takes a (K, ksize) view; got "
                         f"shape {tuple(x.shape)}")
    K, C = x.shape
    if norms.shape != (K,) or not norms.is_contiguous():
        raise ValueError(f"threshold_apply: norms must be a contiguous "
                         f"({K},) vector; got {tuple(norms.shape)}")
    fastest = kernel_fastest(x, "threshold_apply")
    if out is None:
        out = torch.empty_strided(x.shape, x.stride(), dtype=torch.float32,
                                  device=x.device)
    elif (out.device != x.device or out.dtype != torch.float32
          or out.shape != x.shape or out.stride() != x.stride()):
        raise ValueError(f"threshold_apply: out must be a float32 view on "
                         f"{x.device} with x's shape {tuple(x.shape)} and "
                         f"strides {x.stride()}")
    keep = torch.empty(K, dtype=torch.float32, device=x.device)
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"threshold_apply: {n} elements exceed the "
                         f"kernel's 32-bit indexing")
    if n == 0:
        return out, keep
    fn = build.function("sparsify", _THR_SYMBOL, _THR_ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), norms.data_ptr(), out.data_ptr(),
                  keep.data_ptr(), n, K, C, int(fastest), float(thr), stream)
    build.check("sparsify", _THR_SYMBOL, code)
    launches["threshold_apply"] += 1
    return out, keep
