"""Hopper kernel: AIO aggregation, batched (Eq. 5).

Wrapper over ``csrc/aio_agg.cu``, which replaces the reference's
``aio_aggregate`` (``repro/kernels/aio_agg.py``).  The streaming
``aio_absorb``/``aio_merge`` kernels arrive with the hierarchical and
fedbuff paths.  The CPU route is ``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"aio_aggregate": 0}

_SYMBOL = "aio_aggregate_f32"
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p)


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
    out = torch.empty(N, dtype=torch.float32, device=u.device)
    if N == 0:
        return out
    fn = build.function("aio_agg", _SYMBOL, _ARGS)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(u.data_ptr(), m.data_ptr(), w.data_ptr(), out.data_ptr(),
                  I, N, stream)
    build.check("aio_agg", _SYMBOL, code)
    launches["aio_aggregate"] += 1
    return out
