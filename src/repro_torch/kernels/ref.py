"""Plain PyTorch versions of every kernel in this package.

These are the semantics contracts, one per kernel of the reference's
``repro/kernels/ref.py`` ``ORACLES`` table: the CPU route of
``kernels/ops.py`` runs them, and the tests and ``chip_smoke.py`` hold
each CUDA kernel against them on the same inputs.  Scalars may be Python
floats or 0-d tensors; arithmetic is float32 throughout.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F32, device=like.device)


def kernel_sumsq_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise sum of squares. x: (K, ksize) -> (K,) f32."""
    return x.to(F32).square().sum(dim=-1)


def kernel_l2_ref(x: torch.Tensor) -> torch.Tensor:
    """Row-wise L2 norms. x: (K, ksize) -> (K,) f32."""
    return torch.sqrt(kernel_sumsq_ref(x))


def leaf_kernel_shape(shape: tuple) -> tuple[int, int]:
    """(K, ksize): kernels = output units (last axis); a 1-D leaf is one
    kernel."""
    if len(shape) >= 2:
        return shape[-1], math.prod(shape[:-1])
    return 1, math.prod(shape) if shape else 1


def leaf_views(vec: torch.Tensor, shapes) -> list[torch.Tensor]:
    """Each leaf's segment of a flat vector as its (K, ksize) kernel view:
    the transpose of the C-order (ksize, K) buffer, strides (1, K), no
    copy."""
    views = []
    off = 0
    for shape in shapes:
        k, ksize = leaf_kernel_shape(tuple(shape))
        views.append(vec[off:off + k * ksize].view(ksize, k).t())
        off += k * ksize
    return views


def kernel_sumsq_flat_ref(vec: torch.Tensor, shapes) -> torch.Tensor:
    """Every leaf's row sums of squares over a flat update with leaves
    ``shapes``, concatenated -> (K_total,) f32: the plain version of
    ``sparsify.kernel_sumsq_flat``."""
    return torch.cat([kernel_sumsq_ref(x) for x in leaf_views(vec, shapes)])


def kernel_l2_flat_ref(vec: torch.Tensor, shapes) -> torch.Tensor:
    """Every leaf's row L2 norms, concatenated -> (K_total,) f32."""
    return torch.cat([kernel_l2_ref(x) for x in leaf_views(vec, shapes)])


def threshold_mask_ref(x: torch.Tensor, norms: torch.Tensor, thr
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2 elementwise: zero rows whose norm < thr. x: (K, ksize)."""
    keep = (norms >= _scalar(thr, norms)).to(x.dtype)
    return x * keep[:, None], keep


def threshold_apply_flat_ref(vec: torch.Tensor, shapes, norms, thr
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 2 over a flat update with leaves ``shapes``: each leaf view of
    :func:`leaf_views` with its slice of ``norms`` (K_total,) through
    :func:`threshold_mask_ref`, laid back out flat -> (masked (N,), keep
    (K_total,)): the plain version of ``sparsify.threshold_apply_flat``."""
    outs, keeps, k0 = [], [], 0
    for x in leaf_views(vec, shapes):
        k = x.shape[0]
        xm, keep = threshold_mask_ref(x, norms[k0:k0 + k], thr)
        outs.append(xm.t().reshape(-1))
        keeps.append(keep)
        k0 += k
    return torch.cat(outs), torch.cat(keeps)


def quantize_ref(v: torch.Tensor, mask: torch.Tensor, u_min, u_max,
                 n_levels, rand: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. 3-4 with pre-drawn uniforms ``rand`` (same shape as v).

    Returns (dequantized values, int32 level indices)."""
    L = _scalar(n_levels, v)
    u_min = _scalar(u_min, v)
    u_max = _scalar(u_max, v)
    vf = v.to(F32)
    av = vf.abs()
    span = torch.clamp(u_max - u_min, min=1e-20)
    step = span / L
    t = torch.minimum(torch.clamp((av - u_min) / step, min=0.0), L)
    lo = torch.floor(t)
    lvl = lo + (rand < (t - lo)).to(F32)
    lvl = torch.minimum(torch.clamp(lvl, min=0.0), L)
    q = (u_min + lvl * step) * torch.sign(vf)
    nz = mask > 0
    zero = torch.zeros((), dtype=F32, device=v.device)
    q = torch.where(nz, q, zero).to(v.dtype)
    lvl = torch.where(nz, lvl, zero).to(torch.int32)
    return q, lvl


def aio_aggregate_ref(u: torch.Tensor, m: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Eq. 5. u, m: (I, N); w: (I,) -> (N,) f32.

    Sums over devices in order, one at a time, as the CUDA kernel does."""
    num = torch.zeros(u.shape[1], dtype=F32, device=u.device)
    den = torch.zeros_like(num)
    wf = w.to(F32)
    for i in range(u.shape[0]):
        wm = wf[i] * m[i].to(F32)
        num = num + wm * u[i].to(F32)
        den = den + wm
    zero = torch.zeros((), dtype=F32, device=u.device)
    return torch.where(den > 0, num / torch.clamp(den, min=1e-12), zero)


def aio_absorb_ref(num: torch.Tensor, den: torch.Tensor, u: torch.Tensor,
                   m: torch.Tensor, w) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming AIO: fold one update into the (num, den) accumulator.
    num, den, u, m: (N,); w: scalar.  Returns new tensors."""
    wm = _scalar(w, num) * m.to(F32)
    return num + wm * u.to(F32), den + wm


def aio_merge_ref(num_a: torch.Tensor, den_a: torch.Tensor,
                  num_b: torch.Tensor, den_b: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse two streaming-AIO accumulator pairs. All (N,)."""
    return num_a + num_b, den_a + den_b


def fused_sparsify_quantize_ref(x: torch.Tensor, norms: torch.Tensor, thr,
                                u_min, u_max, n_levels, rand: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Composition of Eq. 2 thresholding into Eq. 3-4 stochastic rounding
    (threshold_mask_ref -> quantize_ref). x, rand: (K, ksize)."""
    xm, keep = threshold_mask_ref(x, norms, thr)
    mask = keep[:, None].expand(x.shape) * (xm.abs() > 0)
    q, lvl = quantize_ref(xm.reshape(-1), mask.reshape(-1), u_min, u_max,
                          n_levels, rand.reshape(-1))
    return q.reshape(x.shape), lvl.reshape(x.shape)


def fused_sparsify_quantize_flat_ref(vec: torch.Tensor, shapes, norms,
                                     thr, u_min, u_max, n_levels,
                                     rand: torch.Tensor
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The fused step over a flat update with leaves ``shapes``: each leaf
    view of :func:`leaf_views` with its slice of ``norms`` (K_total,)
    through :func:`fused_sparsify_quantize_ref`, the results laid back out
    flat -> (q (N,), int32 levels (N,)): the plain version of
    ``fused_compress.fused_sparsify_quantize_flat``."""
    qs, lvls, k0 = [], [], 0
    for x, r in zip(leaf_views(vec, shapes), leaf_views(rand, shapes)):
        k = x.shape[0]
        q, lvl = fused_sparsify_quantize_ref(x, norms[k0:k0 + k], thr, u_min,
                                             u_max, n_levels, r)
        qs.append(q.t().reshape(-1))
        lvls.append(lvl.t().reshape(-1))
        k0 += k
    return torch.cat(qs), torch.cat(lvls)


#: kernel name -> plain version; the keys are the reference's ORACLES keys
ORACLES = {
    "aio_aggregate": aio_aggregate_ref,
    "aio_absorb": aio_absorb_ref,
    "aio_merge": aio_merge_ref,
    "kernel_sumsq": kernel_sumsq_ref,
    "kernel_l2": kernel_l2_ref,
    "threshold_apply": threshold_mask_ref,
    "prob_quantize": quantize_ref,
    "fused_sparsify_quantize": fused_sparsify_quantize_ref,
}
