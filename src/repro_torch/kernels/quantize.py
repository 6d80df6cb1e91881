"""Hopper kernel: probabilistic quantization (Eq. 3-4) over a flat vector.

Wrapper over ``csrc/quantize.cu``, which replaces the reference's
``prob_quantize`` (``repro/kernels/quantize.py``), through ``build``'s
lean launch path.  The scalars ``(u_min, u_max, L)`` are float32 values
passed as kernel arguments; the uniforms ``rand`` are an operand.  The CPU
route is ``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"prob_quantize": 0}

_QUANTIZE = build.Entry("quantize", "prob_quantize_f32",
                       (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                        ctypes.c_float, ctypes.c_float, ctypes.c_float))


def prob_quantize(v: torch.Tensor, mask: torch.Tensor, u_min: float,
                  u_max: float, n_levels: float, rand: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """v, mask, rand: contiguous (N,) float32 CUDA vectors.

    Returns (dequantized float32 (N,), int32 levels (N,)), both 0 where
    ``mask`` is 0, from one launch."""
    n = v.numel()
    index = build.f32_vectors("prob_quantize", n, v, mask, rand)
    if n >= 2 ** 31:
        raise ValueError(f"prob_quantize: {n} elements exceed the kernel's "
                         f"32-bit indexing")
    q = torch.empty_like(v)
    # new_empty: empty_like with another dtype costs the host about as
    # much as two allocations
    lvl = v.new_empty(n, dtype=torch.int32)
    if n == 0:
        return q, lvl
    _QUANTIZE.launch(index, v.data_ptr(), mask.data_ptr(), rand.data_ptr(),
                     q.data_ptr(), lvl.data_ptr(), n, float(u_min),
                     float(u_max), float(n_levels))
    launches["prob_quantize"] += 1
    return q, lvl
