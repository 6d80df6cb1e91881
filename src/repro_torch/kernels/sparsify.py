"""Hopper kernels: kernel-wise sparsification (Eq. 2).

Wrappers over ``csrc/sparsify.cu``, which replaces the reference's
``kernel_sumsq``, ``kernel_l2`` and ``threshold_apply``
(``repro/kernels/sparsify.py``).  The norm kernel reads a table of
segments, each a ``(K, ksize)`` float32 view with any strides over one
base pointer: :func:`kernel_l2_flat` takes the whole flat update, one
segment per leaf view of ``ref.leaf_views`` (each leaf's C-order buffer
read as its transpose, strides ``(1, K)``), in one call;
:func:`kernel_l2` takes a single view, a one-segment table.  The threshold
step reads the same tables: :func:`threshold_apply_flat`, the beta
planner's call, takes the whole flat update in one launch and returns the
flat masked vector and the keep vector; :func:`threshold_apply` takes a
single dense view, a one-segment table, through the same C entry.  The
fused compression kernel (``kernels/fused_compress.py``) reads the same
tables too.  The CPU route is ``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import leaf_views

#: launches of the CUDA kernels: ``kernel_sumsq`` counts every call of the
#: norm kernel's C entry, ``kernel_l2`` those with the sqrt epilogue,
#: ``threshold_apply`` every launch of the threshold step
launches = {"kernel_sumsq": 0, "kernel_l2": 0, "threshold_apply": 0}

#: the most segments one norm call takes (the kernel's table is passed by
#: value and must stay within the 4 KB of a launch's parameters)
MAX_SEGMENTS = 64
#: kernels and columns of one tile of the norm kernel (csrc/sparsify.cu)
TILE_ROWS, TILE_CHUNK = 32, 256

_SUMSQ = build.Entry("sparsify", "kernel_sumsq_segments_f32",
                     (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_int))
_THRESHOLD = build.Entry("sparsify", "threshold_apply_segments_f32",
                        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int64, ctypes.c_int64, ctypes.c_float))


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


class SegmentTable(NamedTuple):
    """The norm kernel's work description, built on the host; the fused
    compression kernel reads the first six fields of its rows.

    ``rows`` holds one row per segment: ``(offset, K, C, sK, sC,
    out_base, tile_base, part_base, ktiles)``, element ``(k, c)`` of the
    segment at ``offset + k*sK + c*sC`` from the base pointer and its
    result at ``out[out_base + k]``; the last three place the segment's
    tiles and partial sums.  ``blob`` is ``rows`` as the C entry reads it
    (int64, row-major); ``n_elements`` counts the elements the segments
    read."""
    rows: tuple
    n_elements: int
    k_total: int
    n_tiles: int
    n_partials: int
    blob: bytes


def segment_table(segments: tuple) -> SegmentTable:
    """The table for ``segments``, a tuple of ``(offset, K, C, sK, sC)``
    views laid end to end in the output; raises above
    :data:`MAX_SEGMENTS` segments or past the kernel's 32-bit counts."""
    if not 0 < len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"the norm kernel takes 1 to {MAX_SEGMENTS} "
                         f"segments; got {len(segments)}")
    rows, out, tile, part = [], 0, 0, 0
    for offset, K, C, sK, sC in segments:
        ktiles = -(-K // TILE_ROWS)
        chunks = -(-C // TILE_CHUNK)
        rows.append((offset, K, C, sK, sC, out, tile, part, ktiles))
        out += K
        tile += ktiles * chunks
        part += chunks * K
    if max(out, tile, max(max(r[1], r[2]) for r in rows)) >= 2 ** 31:
        raise ValueError(f"the norm kernel counts kernels, columns and "
                         f"tiles in 32 bits; got {out} kernels, {tile} "
                         f"tiles")
    blob = np.asarray(rows, dtype=np.int64).tobytes()
    return SegmentTable(tuple(rows), sum(r[1] * r[2] for r in rows), out,
                        tile, part, blob)


@functools.lru_cache(maxsize=64)
def flat_table(shapes: tuple) -> SegmentTable:
    """One segment per leaf of a flat update with leaves ``shapes``, in
    order: each leaf's ``(K, ksize)`` view as ``ref.leaf_views`` lays it
    out, read off views of a storage-less vector."""
    n = sum(math.prod(shape) for shape in shapes)
    views = leaf_views(torch.empty(n, device="meta"), shapes)
    return segment_table(tuple((v.storage_offset(), *v.shape, *v.stride())
                               for v in views))


@functools.lru_cache(maxsize=64)
def _view_table(K: int, C: int, sK: int, sC: int) -> SegmentTable:
    return segment_table(((0, K, C, sK, sC),))


def _norms(x: torch.Tensor, index: int, table: SegmentTable,
           take_sqrt: bool) -> torch.Tensor:
    """One call of the C entry over ``table`` from ``x``'s first element."""
    out = x.new_empty((table.k_total,))
    if table.k_total == 0:
        return out
    part = x.new_empty((table.n_partials,))
    _SUMSQ.launch(index, x.data_ptr(), out.data_ptr(), part.data_ptr(),
                  table.blob, len(table.rows), table.n_tiles, table.k_total,
                  int(take_sqrt))
    launches["kernel_sumsq"] += 1
    if take_sqrt:
        launches["kernel_l2"] += 1
    return out


def _view_norms(x: torch.Tensor, take_sqrt: bool) -> torch.Tensor:
    index = x.get_device()
    if index < 0:
        raise ValueError(f"kernel_sumsq launches on CUDA tensors; got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"kernel_sumsq takes float32; got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"kernel_sumsq takes a (K, ksize) view; got "
                         f"shape {tuple(x.shape)}")
    return _norms(x, index, _view_table(*x.shape, *x.stride()), take_sqrt)


def _flat_norms(vec: torch.Tensor, shapes, take_sqrt: bool) -> torch.Tensor:
    table = flat_table(tuple(shapes))
    index = build.f32_vectors("kernel_sumsq", table.n_elements, vec)
    return _norms(vec, index, table, take_sqrt)


def kernel_sumsq(x: torch.Tensor) -> torch.Tensor:
    """x: (K, ksize) float32 CUDA view -> row sums of squares (K,)."""
    return _view_norms(x, take_sqrt=False)


def kernel_l2(x: torch.Tensor) -> torch.Tensor:
    """x: (K, ksize) float32 CUDA view -> row L2 norms (K,)."""
    return _view_norms(x, take_sqrt=True)


def kernel_sumsq_flat(vec: torch.Tensor, shapes) -> torch.Tensor:
    """vec: the contiguous float32 (N,) CUDA vector of an update whose
    leaves have ``shapes`` -> every leaf's kernel sums of squares,
    concatenated (K_total,), in one call."""
    return _flat_norms(vec, shapes, take_sqrt=False)


def kernel_l2_flat(vec: torch.Tensor, shapes) -> torch.Tensor:
    """As :func:`kernel_sumsq_flat`, the L2 norms."""
    return _flat_norms(vec, shapes, take_sqrt=True)


def _threshold(index: int, table: SegmentTable, x: torch.Tensor,
               norms: torch.Tensor, out: torch.Tensor, keep: torch.Tensor,
               thr: float) -> None:
    """One launch over ``table``'s storage offsets from ``x`` and ``out``."""
    n = table.n_elements
    if n >= 2 ** 31:
        raise ValueError(f"threshold_apply: {n} elements exceed the kernel's "
                         f"32-bit indexing")
    if n == 0 and table.k_total == 0:
        return
    _THRESHOLD.launch(index, x.data_ptr(), norms.data_ptr(), out.data_ptr(),
                      keep.data_ptr(), table.blob, len(table.rows), n,
                      table.k_total, float(thr))
    launches["threshold_apply"] += 1


def threshold_apply_flat(vec: torch.Tensor, shapes, norms: torch.Tensor,
                         thr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """vec: the contiguous float32 (N,) CUDA vector of an update whose
    leaves have ``shapes``; norms: every leaf's kernel norms, concatenated
    (K_total,), as :func:`kernel_l2_flat` gives them; thr a float32 value.
    Returns (vec with every kernel below ``thr`` zeroed, flat (N,); the
    float32 keep vector (K_total,)), from one launch."""
    table = flat_table(tuple(shapes))
    index = build.f32_vectors("threshold_apply", table.n_elements, vec)
    if build.f32_vectors("threshold_apply", table.k_total, norms) != index:
        raise ValueError(f"threshold_apply: norms must lie on {vec.device}; "
                         f"got {norms.device}")
    out = torch.empty_like(vec)
    keep = torch.empty_like(norms)
    _threshold(index, table, vec, norms, out, keep, thr)
    return out, keep


def threshold_apply(x: torch.Tensor, norms: torch.Tensor, thr: float
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: dense (K, ksize) float32 CUDA view; norms (K,); thr a float32
    value.  Returns (x * (norms >= thr) per row, laid out like x; the
    float32 keep vector (K,))."""
    index = x.get_device()
    if index < 0:
        raise ValueError(f"threshold_apply launches on CUDA tensors; got "
                         f"{x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"threshold_apply takes float32; got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"threshold_apply takes a (K, ksize) view; got "
                         f"shape {tuple(x.shape)}")
    K, C = x.shape
    if build.f32_vectors("threshold_apply", K, norms) != index:
        raise ValueError(f"threshold_apply: norms must lie on {x.device}; "
                         f"got {norms.device}")
    # the kernel reads a dense view by its layout alone: element j of the
    # storage is kernel j % K (kernel-fastest) or j / C (row-major)
    fastest = kernel_fastest(x, "threshold_apply")
    table = _view_table(K, C, *((1, K) if fastest else (C, 1)))
    out = torch.empty_strided(x.shape, x.stride(), dtype=torch.float32,
                              device=x.device)
    keep = torch.empty_like(norms)
    _threshold(index, table, x, norms, out, keep, thr)
    return out, keep
