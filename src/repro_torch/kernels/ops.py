"""Dispatch by the tensors' device.

CPU tensors go to the plain PyTorch versions (``kernels/ref.py``), and
so do ``meta`` tensors (a trace of shapes, ``launch/dryrun``); CUDA
tensors go to the Hopper kernels, which build at their first use and
raise on any build or launch error.  There is no fallback from one route
to the other, and no switch besides the device the data lies on.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import (aio_agg, fused_compress, grouped_mm, ref,
                                 quantize, sparsify)

_COUNTERS = (sparsify.launches, quantize.launches, fused_compress.launches,
             aio_agg.launches, grouped_mm.launches)


def _on_cuda(*tensors: torch.Tensor) -> bool:
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    # a meta tensor has no data: the plain version computes its shape
    if kinds in ({"cpu"}, {"meta"}):
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


def kernel_l2_flat_op(vec: torch.Tensor, shapes) -> torch.Tensor:
    """Every leaf's kernel L2 norms (Eq. 2's) over a flat update with
    leaves ``shapes``, concatenated (K_total,): one kernel call on CUDA."""
    if _on_cuda(vec):
        return sparsify.kernel_l2_flat(vec, shapes)
    return ref.kernel_l2_flat_ref(vec, shapes)


def threshold_apply_op(x: torch.Tensor, norms: torch.Tensor, thr
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2 on one (K, ksize) leaf view: (x with the rows below ``thr``
    zeroed, laid out like x; the float32 keep vector (K,))."""
    if _on_cuda(x, norms):
        return sparsify.threshold_apply(x, norms, thr)
    return ref.threshold_mask_ref(x, norms, thr)


def threshold_apply_flat_op(vec: torch.Tensor, shapes, norms: torch.Tensor,
                            thr) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2 over a flat update with leaves ``shapes`` and its norms
    (K_total,) -> (the flat masked vector (N,), the float32 keep vector
    (K_total,)): one kernel launch on CUDA."""
    if _on_cuda(vec, norms):
        return sparsify.threshold_apply_flat(vec, shapes, norms, thr)
    return ref.threshold_apply_flat_ref(vec, shapes, norms, thr)


def prob_quantize_op(v: torch.Tensor, mask: torch.Tensor, u_min, u_max,
                     n_levels, rand: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    if _on_cuda(v, mask, rand):
        return quantize.prob_quantize(v, mask, u_min, u_max, n_levels, rand)
    return ref.quantize_ref(v, mask, u_min, u_max, n_levels, rand)


def fused_sparsify_quantize_flat_op(vec: torch.Tensor, shapes,
                                    norms: torch.Tensor, thr, u_min, u_max,
                                    n_levels, rand: torch.Tensor
                                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2-4 over a flat update with leaves ``shapes`` and its norms
    (K_total,) -> flat (q (N,), int32 levels (N,)): one kernel launch on
    CUDA."""
    if _on_cuda(vec, norms, rand):
        return fused_compress.fused_sparsify_quantize_flat(
            vec, shapes, norms, thr, u_min, u_max, n_levels, rand)
    return ref.fused_sparsify_quantize_flat_ref(vec, shapes, norms, thr,
                                                u_min, u_max, n_levels, rand)


def aio_aggregate_op(u: torch.Tensor, m: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    if _on_cuda(u, m, w):
        return aio_agg.aio_aggregate(u, m, w)
    return ref.aio_aggregate_ref(u, m, w)


# The streaming pair updates the (num, den) accumulator IN PLACE on both
# routes (the TPU kernels alias their outputs onto it) and returns
# nothing: a caller that still needs the old planes must copy them first.

def aio_absorb_op(num: torch.Tensor, den: torch.Tensor, u: torch.Tensor,
                  m: torch.Tensor, w: float) -> None:
    """``num += w*m*u``, ``den += w*m`` in place; w rounded to float32."""
    if _on_cuda(num, den, u, m):
        aio_agg.aio_absorb(num, den, u, m, w)
        return
    wm = torch.as_tensor(w, dtype=ref.F32) * m
    num.add_(wm * u)
    den.add_(wm)


def aio_merge_op(num_a: torch.Tensor, den_a: torch.Tensor,
                 num_b: torch.Tensor, den_b: torch.Tensor) -> None:
    """``num_a += num_b``, ``den_a += den_b`` in place."""
    if _on_cuda(num_a, den_a, num_b, den_b):
        aio_agg.aio_merge(num_a, den_a, num_b, den_b)
        return
    num_a.add_(num_b)
    den_a.add_(den_b)


def _grouped_route(*tensors: torch.Tensor):
    """(product, weight-gradient product) of the grouped GEMM on the
    operands' device: the card's launches or the plain loops."""
    if _on_cuda(*tensors):
        return grouped_mm.grouped_mm, grouped_mm.grouped_mm_t
    return grouped_mm.grouped_mm_ref, grouped_mm.grouped_mm_t_ref


class _GroupedMM(torch.autograd.Function):
    """``grouped_mm``'s product with its backward: the input gradient is
    the same grouped product by the transposed matrices, the weight
    gradient the group-wise ``x.T @ dy``; on the card each is one
    launch."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return _grouped_route(x, w, offs)[0](x, w, offs)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        mm, mm_t = _grouped_route(dy, w, offs)
        dx = mm(dy, w.transpose(1, 2), offs) if ctx.needs_input_grad[0] \
            else None
        dw = mm_t(x, dy, offs) if ctx.needs_input_grad[1] else None
        return dx, dw, None


def grouped_mm_op(x: torch.Tensor, w: torch.Tensor,
                  offs: torch.Tensor) -> torch.Tensor:
    """Rows ``offs[g-1]:offs[g]`` of ``x`` (M, k) times ``w[g]`` (k, n),
    differentiable in ``x`` and ``w``: one launch a product on the card
    (bf16), a loop over the groups on the CPU."""
    return _GroupedMM.apply(x, w, offs)


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

