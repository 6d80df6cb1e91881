"""Hopper kernel: fused sparsify + probabilistic quantize (FGC in one pass).

Wrapper over ``csrc/fused_compress.cu``, which replaces the reference's
``fused_sparsify_quantize`` (``repro/kernels/fused_compress.py``).  The
kernel reads the norm kernel's segment table (``sparsify.SegmentTable``):
:func:`fused_sparsify_quantize_flat`, the main path's call, takes the whole
flat update in one launch, one segment per leaf view of
``ref.leaf_views``, and returns flat ``q`` and ``lvl``;
:func:`fused_sparsify_quantize` takes a single dense ``(K, ksize)`` view, a
one-segment table, through the same C entry.  Both launch through
``build``'s lean path.  The scalars ``(thr, u_min, u_max, L)`` are float32
values passed as kernel arguments; the uniforms ``rand`` are an operand.
The CPU route is ``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, sparsify

launches = {"fused_sparsify_quantize": 0}

_FUSED = build.Entry("fused_compress", "fused_sparsify_quantize_f32",
                     (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int64, ctypes.c_float,
                      ctypes.c_float, ctypes.c_float, ctypes.c_float))


def _launch(index: int, table: sparsify.SegmentTable, x: torch.Tensor,
            rand: torch.Tensor, norms: torch.Tensor, q: torch.Tensor,
            lvl: torch.Tensor, scalars: tuple) -> None:
    """One launch over ``table``'s storage offsets from each base pointer."""
    n = table.n_elements
    if n >= 2 ** 31:
        raise ValueError(f"fused_sparsify_quantize: {n} elements exceed the "
                         f"kernel's 32-bit indexing")
    if n == 0:
        return
    _FUSED.launch(index, x.data_ptr(), rand.data_ptr(), norms.data_ptr(),
                  q.data_ptr(), lvl.data_ptr(), table.blob, len(table.rows),
                  n, *scalars)
    launches["fused_sparsify_quantize"] += 1


def fused_sparsify_quantize_flat(vec: torch.Tensor, shapes,
                                 norms: torch.Tensor, thr: float,
                                 u_min: float, u_max: float, n_levels: float,
                                 rand: torch.Tensor
                                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """vec, rand: the contiguous float32 (N,) CUDA vectors of an update
    whose leaves have ``shapes`` and of its uniforms; norms: every leaf's
    kernel norms, concatenated (K_total,), as ``sparsify.kernel_l2_flat``
    gives them.  Returns (dequantized float32 (N,), int32 levels (N,)) in
    the flat layout, from one launch."""
    table = sparsify.flat_table(tuple(shapes))
    index = build.f32_vectors("fused_sparsify_quantize", table.n_elements,
                              vec, rand)
    if build.f32_vectors("fused_sparsify_quantize", table.k_total,
                         norms) != index:
        raise ValueError(f"fused_sparsify_quantize: norms must lie on "
                         f"{vec.device}; got {norms.device}")
    q = torch.empty_like(vec)
    lvl = torch.empty_like(vec, dtype=torch.int32)
    _launch(index, table, vec, rand, norms, q, lvl,
            (float(thr), float(u_min), float(u_max), float(n_levels)))
    return q, lvl


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
    fastest = sparsify.kernel_fastest(x, "fused_sparsify_quantize")
    if sparsify.kernel_fastest(rand, "fused_sparsify_quantize") != fastest:
        raise ValueError("fused_sparsify_quantize: rand must share x's "
                         "layout")
    # the kernel reads a dense view by its layout alone: element j of the
    # storage is kernel j % K (kernel-fastest) or j / C (row-major)
    table = sparsify._view_table(K, C, *((1, K) if fastest else (C, 1)))
    q = torch.empty_strided(x.shape, x.stride(), dtype=torch.float32,
                            device=x.device)
    lvl = torch.empty_strided(x.shape, x.stride(), dtype=torch.int32,
                              device=x.device)
    _launch(x.get_device(), table, x, rand, norms, q, lvl,
            (float(thr), float(u_min), float(u_max), float(n_levels)))
    return q, lvl
