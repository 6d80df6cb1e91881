"""Hopper kernel: kernel-wise sums of squares and L2 norms (Eq. 2 norms).

Wrappers over ``csrc/sparsify.cu``, which replaces the reference's
``kernel_sumsq`` and ``kernel_l2`` (``repro/kernels/sparsify.py``).  Both
take a ``(K, ksize)`` float32 CUDA view with any strides; the main path
passes each leaf's C-order buffer as its transpose, strides ``(1, K)``,
without a copy.  The CPU route is ``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel: ``kernel_sumsq`` counts every launch,
#: ``kernel_l2`` those with the sqrt epilogue
launches = {"kernel_sumsq": 0, "kernel_l2": 0}

_SYMBOL = "kernel_sumsq_f32"
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p)


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
