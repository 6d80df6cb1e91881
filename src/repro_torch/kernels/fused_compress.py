"""Hopper kernel: fused sparsify + probabilistic quantize (FGC in one pass).

Wrapper over ``csrc/fused_compress.cu``, which replaces the reference's
``fused_sparsify_quantize`` (``repro/kernels/fused_compress.py``).  The
scalars ``(thr, u_min, u_max, L)`` are float32 values passed as kernel
arguments; the uniforms ``rand`` are an operand.  The CPU route is
``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"fused_sparsify_quantize": 0}

_SYMBOL = "fused_sparsify_quantize_f32"
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
         ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
         ctypes.c_float, ctypes.c_void_p)


def kernel_fastest(t: torch.Tensor, kernel: str) -> bool:
    """True for a dense (K, C) view whose kernel index varies fastest in
    memory (the transpose of a C-order leaf), False for row-major; any
    other layout raises, naming ``kernel``."""
    if t.t().is_contiguous():
        return True
    if t.is_contiguous():
        return False
    raise ValueError(f"{kernel} takes a dense (K, ksize) view; got strides "
                     f"{t.stride()} for shape {tuple(t.shape)}")


def fused_sparsify_quantize(x: torch.Tensor, norms: torch.Tensor, thr: float,
                            u_min: float, u_max: float, n_levels: float,
                            rand: torch.Tensor
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """x, rand: (K, ksize) float32 CUDA views of one layout; norms (K,).

    Returns (dequantized float32, int32 levels), laid out like x."""
    for name, t in (("x", x), ("rand", rand), ("norms", norms)):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"fused_sparsify_quantize: {name} must be on "
                             f"{x.device} (CUDA); got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"fused_sparsify_quantize: {name} must be "
                            f"float32; got {t.dtype}")
    if x.dim() != 2 or rand.shape != x.shape:
        raise ValueError(f"fused_sparsify_quantize: x and rand must be one "
                         f"(K, ksize) shape; got {tuple(x.shape)} and "
                         f"{tuple(rand.shape)}")
    K, C = x.shape
    if norms.shape != (K,) or not norms.is_contiguous():
        raise ValueError(f"fused_sparsify_quantize: norms must be a "
                         f"contiguous ({K},) vector; got "
                         f"{tuple(norms.shape)}")
    fastest = kernel_fastest(x, "fused_sparsify_quantize")
    if kernel_fastest(rand, "fused_sparsify_quantize") != fastest:
        raise ValueError("fused_sparsify_quantize: rand must share x's "
                         "layout")
    n = x.numel()
    if n >= 2 ** 31:
        raise ValueError(f"fused_sparsify_quantize: {n} elements exceed "
                         f"the kernel's 32-bit indexing")
    q = torch.empty_strided(x.shape, x.stride(), dtype=torch.float32,
                            device=x.device)
    lvl = torch.empty_strided(x.shape, x.stride(), dtype=torch.int32,
                              device=x.device)
    if n == 0:
        return q, lvl
    fn = build.function("fused_compress", _SYMBOL, _ARGS)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(x.data_ptr(), rand.data_ptr(), norms.data_ptr(),
                  q.data_ptr(), lvl.data_ptr(), n, K, C, int(fastest),
                  float(thr), float(u_min), float(u_max), float(n_levels),
                  stream)
    build.check("fused_compress", _SYMBOL, code)
    launches["fused_sparsify_quantize"] += 1
    return q, lvl
