"""FGC — Flexible Gradient Compression (paper §III-C).

Pipeline over a local update pytree ``u``:

1. *Kernel-wise sparsification* (Eq. 2): per-kernel L2 norms (a kernel = one
   output unit's fan-in slice: conv filters, linear columns; 1-D leaves are
   one kernel), global threshold = the ``ceil((1-rho)*K)``-th largest norm
   (``rho`` is the *removed* fraction), kernels below the threshold are
   zeroed.
2. *Probabilistic quantization* (Eq. 3-4): uniform magnitude grid with L
   intervals on [u_min, u_max] of the surviving non-zero magnitudes,
   unbiased stochastic rounding, sign preserved.
3. *Lossless coding size model*: empirical-entropy bits for the level
   indices + Golomb bits for the sparsity mask + header.

:func:`compress_update` runs the norms through the ``kernel_l2`` kernel
and steps 1-2 through the ``fused_sparsify_quantize`` kernel, one call
each over every leaf of the flat update (``kernels/ops.py`` picks the
plain versions for CPU tensors).
:meth:`BetaPlanner.fit` keeps the reference's structure instead: step 1
once per ``rho`` over every leaf of the flat update (``threshold_apply``,
one launch) and step 2 once per ``(rho, L)`` over the flat masked vector
(``prob_quantize``, one launch).  The threshold (a sort of the K norms)
and the masked ``u_min``/``u_max`` are plain reductions, as in the
reference.  :func:`sparsify_mask` and :func:`prob_quantize` keep the
reference's composition over the flat vector; the tests hold the kernel
routes against them.

Randomness is an input: where the reference draws uniforms from a JAX
key, these functions take them as ``rand`` (one float32 per element of
the flat update), so a test can hand both the same draw.  Arithmetic is
float32 wherever the reference's is, including the kept count
``ceil((1 - rho) * K)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.aggregation import sqrt_f32
from repro_torch.kernels import ops
from repro_torch.kernels.ref import leaf_kernel_shape
from repro_torch.kernels.ref import leaf_views as _leaf_views
from repro_torch.utils.pytree import flatten_to_vector, tree_leaves

PyTree = Any
F32 = torch.float32
HEADER_BITS = 2 * 32 + 16      # u_min, u_max float32 + L uint16
MAX_LEVELS = 65535


# ----------------------------------------------------------- kernel structure

def kernel_segments(tree: PyTree) -> tuple[np.ndarray, int]:
    """Element -> kernel-id map for the flattened update vector.

    Returns (segment_ids (N,), total kernel count K): row ``k`` of each
    leaf's :func:`_leaf_views` view holds its kernel's id."""
    shapes = [tuple(leaf.shape) for leaf in tree_leaves(tree)]
    seg = np.empty(sum(math.prod(s) for s in shapes), np.int32)
    kid = 0
    for v in _leaf_views(torch.from_numpy(seg), shapes):
        k = v.shape[0]
        v.copy_(torch.arange(kid, kid + k, dtype=torch.int32)[:, None]
                .expand_as(v))
        kid += k
    return seg, kid


def _from_views(views: list[torch.Tensor]) -> torch.Tensor:
    """Inverse of :func:`_leaf_views`: back to one flat vector."""
    return torch.cat([v.t().reshape(-1) for v in views])


def _element_mask(keep: torch.Tensor, shapes: list) -> torch.Tensor:
    """The flat elementwise {0,1} mask of a keep vector (K_total,): each
    leaf's kernel flags broadcast over its ``(K, ksize)`` view."""
    views, k0 = [], 0
    for shape in shapes:
        k, ksize = leaf_kernel_shape(shape)
        views.append(keep[k0:k0 + k, None].expand(k, ksize))
        k0 += k
    return _from_views(views)


# ------------------------------------------------------------- sparsification

def kernel_norms(v: torch.Tensor, seg_ids: np.ndarray, n_kernels: int
                 ) -> torch.Tensor:
    """Per-kernel L2 norms of the flat update vector (segment sum)."""
    seg = torch.as_tensor(seg_ids, dtype=torch.long, device=v.device)
    sq = torch.zeros(n_kernels, dtype=F32, device=v.device)
    return torch.sqrt(sq.index_add_(0, seg, v.to(F32).square()))


def sparsify_threshold(norms: torch.Tensor, rho) -> torch.Tensor:
    """Eq. 2's threshold: the exact ``ceil((1-rho)*K)``-th largest norm.

    The kept count is computed in float32, as the reference does: in
    float64 it can differ by one.  At ``rho == 1`` the index clips to the
    largest norm, so the top kernel (and its ties) always survives."""
    K = norms.shape[0]
    rho = torch.clamp(torch.as_tensor(rho, dtype=F32), 0.0, 1.0)
    kept = torch.ceil((1.0 - rho) * K)
    idx = int(torch.clamp(K - kept, 0, K - 1))
    return torch.sort(norms).values[idx]


def sparsify_mask(v: torch.Tensor, seg_ids: np.ndarray, n_kernels: int,
                  rho) -> torch.Tensor:
    """Eq. 2 — keep the top ``ceil((1-rho)*K)`` kernels by L2 norm.

    Returns the elementwise {0,1} mask."""
    norms = kernel_norms(v, seg_ids, n_kernels)
    keep = norms >= sparsify_threshold(norms, rho)
    seg = torch.as_tensor(seg_ids, dtype=torch.long, device=v.device)
    return keep[seg].to(v.dtype)


# -------------------------------------------------------------- quantization

class Quantized(NamedTuple):
    values: torch.Tensor     # dequantized values (same shape as input)
    levels: torch.Tensor     # int32 level index per element (0 where masked)
    u_min: torch.Tensor
    u_max: torch.Tensor


def masked_range(v: torch.Tensor, mask: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """(u_min, u_max) of the surviving magnitudes: the smallest non-zero
    and the largest masked ``|v|``, 0 where none survives."""
    av = v.abs() * mask
    nz = mask > 0
    inf = torch.tensor(float("inf"), dtype=F32, device=v.device)
    zero = torch.zeros((), dtype=F32, device=v.device)
    u_min = torch.where(nz & (av > 0), av, inf).min()
    u_min = torch.where(torch.isfinite(u_min), u_min, zero)
    u_max = torch.where(nz, av, -inf).max()
    u_max = torch.where(torch.isfinite(u_max), u_max, zero)
    return u_min, u_max


def prob_quantize(v: torch.Tensor, mask: torch.Tensor, n_levels,
                  rand: torch.Tensor) -> Quantized:
    """Eq. 3-4 — probabilistic quantization of the surviving elements,
    with pre-drawn uniforms ``rand`` (same shape as v).

    Grid: L+1 points u_min + l*(u_max-u_min)/L, l=0..L, on |v|; stochastic
    rounding to the two neighbours with probability proportional to
    proximity (unbiased: E[q] = v)."""
    L = torch.as_tensor(n_levels, dtype=F32, device=v.device)
    av = v.abs() * mask
    nz = mask > 0
    u_min, u_max = masked_range(v, mask)
    step = torch.clamp(u_max - u_min, min=1e-20) / L
    t = torch.minimum(torch.clamp((av - u_min) / step, min=0.0), L)
    lo = torch.floor(t)
    lvl = lo + (rand < t - lo).to(F32)
    lvl = torch.minimum(torch.clamp(lvl, min=0.0), L)
    q = (u_min + lvl * step) * torch.sign(v)
    zero = torch.zeros((), dtype=F32, device=v.device)
    q = torch.where(nz, q, zero)
    lvl = torch.where(nz, lvl, zero).to(torch.int32)
    return Quantized(q.to(v.dtype), lvl, u_min, u_max)


# ---------------------------------------------------------------- size model

def entropy_bits(levels: torch.Tensor, mask: torch.Tensor, n_levels: int
                 ) -> torch.Tensor:
    """Empirical-entropy coded size (bits) of the level indices (+signs).

    The histogram has ``n_levels + 1`` bins; the callers pass
    ``MAX_LEVELS``, as the reference does."""
    mask = mask.to(F32)
    nnz = torch.clamp(mask.sum(), min=1.0)
    hist = torch.zeros(int(n_levels) + 1, dtype=F32, device=mask.device)
    hist.index_add_(0, levels.long(), mask)
    p = hist / nnz
    terms = p * torch.log2(torch.clamp(p, min=1e-12))
    h = -torch.where(p > 0, terms, torch.zeros_like(terms)).sum()
    return nnz * (h + 1.0)     # +1 sign bit per surviving element


def golomb_bits(mask: torch.Tensor) -> torch.Tensor:
    """Golomb-coded size (bits) of the sparsity mask ([11], [38]): the
    expected code length of the optimal power-of-two parameter at the
    empirical density, per kept element."""
    n = mask.numel()
    kept = mask.to(F32).sum()
    p = torch.clamp(kept / n, 1e-9, 1 - 1e-9)
    m_star = -1.0 / torch.log2(1.0 - p)
    b = torch.ceil(torch.log2(torch.clamp(m_star, min=1.0)))
    m = torch.exp2(b)
    exp_len = b + 1.0 / (1.0 - torch.pow(1.0 - p, m))
    return kept * exp_len


def compressed_bits(q: Quantized, mask: torch.Tensor, n_levels: int
                    ) -> torch.Tensor:
    return entropy_bits(q.levels, mask, n_levels) + golomb_bits(mask) \
        + HEADER_BITS


# ------------------------------------------------------ compression pipeline

class CompressedUpdate(NamedTuple):
    """A compressed local update, full-coordinate (server view, decoded)."""
    values: PyTree           # dequantized update (zeros where dropped)
    mask: PyTree             # {0,1} elementwise mask of transmitted elements
    bits: torch.Tensor       # modelled wire size (0-d float32)
    rho: float
    n_levels: float


def analytic_rho(beta) -> float:
    """Appendix A: sparsity rho = 1 - sqrt(beta), in float32."""
    return float(1.0 - sqrt_f32(torch.as_tensor(beta, dtype=F32)))


def analytic_levels(beta, bit_width: int = 32, cap: int = MAX_LEVELS
                    ) -> float:
    """Appendix A: L = 2**(bit_width*sqrt(beta)) in float32, clipped to
    [2, cap]; not rounded to an integer, as in the reference."""
    L = torch.exp2(bit_width * sqrt_f32(torch.as_tensor(beta, dtype=F32)))
    return float(torch.clamp(L, 2.0, float(cap)))


class _Fgc(NamedTuple):
    values: torch.Tensor     # (N,) dequantized
    levels: torch.Tensor     # (N,) int32
    mask: torch.Tensor       # (N,) float32 {0,1} sparsity mask
    bits: torch.Tensor


def _norms(vec: torch.Tensor, shapes: list) -> torch.Tensor:
    """Per-kernel norms of the flat update: one ``kernel_l2`` call over
    every leaf."""
    return ops.kernel_l2_flat_op(vec, shapes)


def _sparsify_quantize(vec: torch.Tensor, shapes: list, norms: torch.Tensor,
                       rho, n_levels, rand: torch.Tensor,
                       max_levels: int) -> _Fgc:
    """Eq. 2-4 over a flat update whose per-kernel norms are known: one
    ``fused_sparsify_quantize`` call over every leaf, then the size
    model."""
    thr = sparsify_threshold(norms, rho)
    mask = _element_mask((norms >= thr).to(F32), shapes)
    u_min, u_max = masked_range(vec, mask)
    # one host sync: the scalars ride into the kernel as arguments
    thr_f, u_min_f, u_max_f = torch.stack([thr, u_min, u_max]).tolist()
    values, levels = ops.fused_sparsify_quantize_flat_op(
        vec, shapes, norms, thr_f, u_min_f, u_max_f, float(n_levels), rand)
    q = Quantized(values, levels, u_min, u_max)
    return _Fgc(values, levels, mask, compressed_bits(q, mask, max_levels))


def compress_update(update: PyTree, beta, rand: torch.Tensor,
                    rho: Optional[float] = None,
                    n_levels: Optional[float] = None,
                    max_levels: int = MAX_LEVELS) -> CompressedUpdate:
    """FGC end-to-end on an update pytree with target rate ``beta``.

    ``rand`` holds one uniform per element of the flattened update (the
    reference draws them from its key).  If (rho, n_levels) are not given,
    uses the analytic Appendix-A split."""
    rho = analytic_rho(beta) if rho is None else float(rho)
    n_levels = analytic_levels(beta) if n_levels is None \
        else float(n_levels)
    vec, unflatten = flatten_to_vector(update)
    shapes = [tuple(x.shape) for x in tree_leaves(update)]
    fgc = _sparsify_quantize(vec, shapes, _norms(vec, shapes), rho,
                             n_levels, rand, max_levels)
    return CompressedUpdate(values=unflatten(fgc.values),
                            mask=unflatten(fgc.mask), bits=fgc.bits,
                            rho=rho, n_levels=n_levels)


# -------------------------------------------------------------- beta planner

@dataclasses.dataclass
class BetaPlanner:
    """Server-side piecewise-linear (beta -> rho, L) map (§III-C.3).

    Fit offline from a probe update: sweep (rho, L) combinations, record
    achieved rate, and keep for each target rate the divergence-minimizing
    pair, linearly interpolated at runtime."""
    betas: np.ndarray
    rhos: np.ndarray
    levels: np.ndarray

    @staticmethod
    def fit(probe_update: PyTree, rand: torch.Tensor,
            rho_grid=(0.0, 0.3, 0.5, 0.7, 0.8, 0.9, 0.95, 0.99),
            level_grid=(2, 4, 8, 16, 32, 64, 128, 256, 1024, 4096)
            ) -> "BetaPlanner":
        """``rand``: one uniform per probe element, shared by every (rho, L)
        as the reference shares one key."""
        vec, _ = flatten_to_vector(probe_update)
        shapes = [tuple(x.shape) for x in tree_leaves(probe_update)]
        norms = _norms(vec, shapes)
        n = vec.numel()
        records = []
        for rho in rho_grid:
            # Eq. 2 once per rho: one threshold_apply call over every leaf
            thr = float(sparsify_threshold(norms, rho))
            masked, keep = ops.threshold_apply_flat_op(vec, shapes, norms,
                                                       thr)
            mask = _element_mask(keep, shapes)
            u_min, u_max = masked_range(masked, mask)
            u_min_f, u_max_f = torch.stack([u_min, u_max]).tolist()
            # Eq. 3-4 once per (rho, L) over the flat vector
            for L in level_grid:
                values, levels = ops.prob_quantize_op(
                    masked, mask, u_min_f, u_max_f, float(L), rand)
                bits = compressed_bits(Quantized(values, levels, u_min,
                                                 u_max), mask, MAX_LEVELS)
                beta = float(bits) / (32.0 * n)
                err = float(torch.linalg.vector_norm(values * mask - vec))
                records.append((beta, rho, L, err))
        # pareto: for ascending beta keep min-err
        records.sort()
        betas, rhos, levels = [], [], []
        best = np.inf
        for beta, rho, L, err in records:
            if err < best:
                best = err
                betas.append(beta)
                rhos.append(rho)
                levels.append(L)
        return BetaPlanner(np.asarray(betas), np.asarray(rhos, np.float64),
                           np.asarray(levels, np.float64))

    def plan(self, beta: float) -> tuple[float, int]:
        """Target rate -> (rho, L) by piecewise-linear interpolation."""
        b = float(np.clip(beta, self.betas[0], self.betas[-1]))
        rho = float(np.interp(b, self.betas, self.rhos))
        lvl = int(round(float(np.interp(b, self.betas, self.levels))))
        return rho, max(lvl, 2)
