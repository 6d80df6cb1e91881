"""Hopper kernels: AIO aggregation (Eq. 5), batched and streaming.

Wrappers over ``csrc/aio_agg.cu``, which replaces the reference's
``aio_aggregate``, ``aio_absorb`` and ``aio_merge``
(``repro/kernels/aio_agg.py``).  ``aio_absorb`` and ``aio_merge`` update
the ``(num, den)`` accumulator in its own storage, as the TPU kernels
alias their outputs onto it.  All three launch through ``build``'s lean
path.
The CPU route is ``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"aio_aggregate": 0, "aio_absorb": 0, "aio_merge": 0}

_AGGREGATE = build.Entry("aio_agg", "aio_aggregate_f32",
                         (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64))
_ABSORB = build.Entry("aio_agg", "aio_absorb_f32",
                      (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_float, ctypes.c_int64))
_MERGE = build.Entry("aio_agg", "aio_merge_f32",
                     (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int64))


def aio_aggregate(u: torch.Tensor, m: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """u, m: (I, N) float32 contiguous CUDA; w: (I,) -> (N,) float32."""
    for name, t in (("u", u), ("m", m), ("w", w)):
        if t.device.type != "cuda" or t.device != u.device:
            raise ValueError(f"aio_aggregate: {name} must be on {u.device} "
                             f"(CUDA); got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"aio_aggregate: {name} must be float32; got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"aio_aggregate: {name} must be contiguous")
    if u.dim() != 2 or m.shape != u.shape or w.shape != (u.shape[0],):
        raise ValueError(f"aio_aggregate: expected u, m (I, N) and w (I,); "
                         f"got {tuple(u.shape)}, {tuple(m.shape)}, "
                         f"{tuple(w.shape)}")
    I, N = u.shape
    out = u.new_empty(N)
    if N == 0:
        return out
    _AGGREGATE.launch(u.get_device(), u.data_ptr(), m.data_ptr(),
                      w.data_ptr(), out.data_ptr(), I, N)
    launches["aio_aggregate"] += 1
    return out


def aio_absorb(num: torch.Tensor, den: torch.Tensor, u: torch.Tensor,
               m: torch.Tensor, w: float) -> None:
    """In place: ``num += w*m*u``, ``den += w*m``; all (N,) float32
    contiguous CUDA vectors, ``w`` rounded to float32.  The launch goes
    through ``build``'s lean path, as :func:`aio_merge`'s does."""
    n = num.numel()
    index = build.f32_vectors("aio_absorb", n, num, den, u, m)
    if n == 0:
        return
    _ABSORB.launch(index, num.data_ptr(), den.data_ptr(), u.data_ptr(),
                   m.data_ptr(), float(w), n)
    launches["aio_absorb"] += 1


def aio_merge(num_a: torch.Tensor, den_a: torch.Tensor, num_b: torch.Tensor,
              den_b: torch.Tensor) -> None:
    """In place: ``num_a += num_b``, ``den_a += den_b``; all (N,) float32
    contiguous CUDA vectors.  The launch goes through ``build``'s lean
    path, so its host cost stays below the kernel's device time."""
    n = num_a.numel()
    index = build.f32_vectors("aio_merge", n, num_a, den_a, num_b, den_b)
    if n == 0:
        return
    _MERGE.launch(index, num_a.data_ptr(), den_a.data_ptr(),
                  num_b.data_ptr(), den_b.data_ptr(), n)
    launches["aio_merge"] += 1
