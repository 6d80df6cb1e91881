"""Hopper kernel: probabilistic quantization (Eq. 3-4) over a flat vector.

Wrapper over ``csrc/quantize.cu``, which replaces the reference's
``prob_quantize`` (``repro/kernels/quantize.py``).  The scalars
``(u_min, u_max, L)`` are float32 values passed as kernel arguments; the
uniforms ``rand`` are an operand.  The CPU route is ``kernels/ops.py``'s.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = {"prob_quantize": 0}

_SYMBOL = "prob_quantize_f32"
_ARGS = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
         ctypes.c_float, ctypes.c_void_p)


def prob_quantize(v: torch.Tensor, mask: torch.Tensor, u_min: float,
                  u_max: float, n_levels: float, rand: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """v, mask, rand: contiguous (N,) float32 CUDA vectors.

    Returns (dequantized float32 (N,), int32 levels (N,)), both 0 where
    ``mask`` is 0."""
    for name, t in (("v", v), ("mask", mask), ("rand", rand)):
        if t.device.type != "cuda" or t.device != v.device:
            raise ValueError(f"prob_quantize: {name} must be on {v.device} "
                             f"(CUDA); got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"prob_quantize: {name} must be float32; got "
                            f"{t.dtype}")
        if t.dim() != 1 or t.shape != v.shape or not t.is_contiguous():
            raise ValueError(f"prob_quantize: {name} must be a contiguous "
                             f"vector of v's shape {tuple(v.shape)}; got "
                             f"{tuple(t.shape)}, strides {t.stride()}")
    n = v.numel()
    if n >= 2 ** 31:
        raise ValueError(f"prob_quantize: {n} elements exceed the kernel's "
                         f"32-bit indexing")
    q = torch.empty(n, dtype=torch.float32, device=v.device)
    lvl = torch.empty(n, dtype=torch.int32, device=v.device)
    if n == 0:
        return q, lvl
    fn = build.function("quantize", _SYMBOL, _ARGS)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = fn(v.data_ptr(), mask.data_ptr(), rand.data_ptr(),
                  q.data_ptr(), lvl.data_ptr(), n, float(u_min),
                  float(u_max), float(n_levels), stream)
    build.check("quantize", _SYMBOL, code)
    launches["prob_quantize"] += 1
    return q, lvl
