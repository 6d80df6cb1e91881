"""Dispatch by the tensors' device.

CPU tensors go to the plain PyTorch versions (``kernels/ref.py``); CUDA
tensors go to the Hopper kernels, which build at their first use and
raise on any build or launch error.  There is no fallback from one route
to the other, and no switch besides the device the data lies on.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aio_agg, fused_compress, ref, sparsify

_COUNTERS = (sparsify.launches, fused_compress.launches, aio_agg.launches)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"kernel operands must all lie on one CUDA device or "
                     f"all on the CPU; got {sorted(kinds)}")


def kernel_sumsq_op(x: torch.Tensor) -> torch.Tensor:
    if _on_cuda(x):
        return sparsify.kernel_sumsq(x)
    return ref.kernel_sumsq_ref(x)


def kernel_l2_op(x: torch.Tensor) -> torch.Tensor:
    if _on_cuda(x):
        return sparsify.kernel_l2(x)
    return ref.kernel_l2_ref(x)


def fused_sparsify_quantize_op(x, norms, thr, u_min, u_max, n_levels, rand):
    if _on_cuda(x, norms, rand):
        return fused_compress.fused_sparsify_quantize(
            x, norms, thr, u_min, u_max, n_levels, rand)
    return ref.fused_sparsify_quantize_ref(x, norms, thr, u_min, u_max,
                                           n_levels, rand)


def aio_aggregate_op(u: torch.Tensor, m: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    if _on_cuda(u, m, w):
        return aio_agg.aio_aggregate(u, m, w)
    return ref.aio_aggregate_ref(u, m, w)


def launch_counts() -> dict[str, int]:
    """Launches of every CUDA kernel wrapper since the last reset."""
    out: dict[str, int] = {}
    for c in _COUNTERS:
        out.update(c)
    return out


def reset_launch_counts() -> None:
    for c in _COUNTERS:
        for k in c:
            c[k] = 0
