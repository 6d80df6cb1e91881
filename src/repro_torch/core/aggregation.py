"""AIO — All-in-One aggregation (paper §III-D, Theorem 1).

Element-wise masked weighted averaging of heterogeneous local updates
(different sub-model widths, different sparsity patterns):

    u[j] = sum_i p_i m_i[j] u_i[j] / sum_i p_i m_i[j]     (Eq. 5)
           0 where no device covers j

with optimal coefficients (Theorem 1):

    p_i* ∝ 1 / (1 - alpha_i (2 - alpha_i) sqrt(beta_i))^2  (Eq. 13)

Updates arrive zero-padded to full coordinates with their explicit {0,1}
masks; the denominator comes from those masks, never from ``values != 0``
(a coordinate quantized to zero still counts).  :func:`aio_aggregate`
stacks the flat updates and masks once as ``(I, N)`` and launches the
``aio_aggregate`` kernel once.  The coefficients are float32 on the CPU.

The streaming form is the :class:`PartialAgg` monoid: unnormalized
running sums ``num = sum_i w_i m_i u_i`` and ``den = sum_i w_i m_i``,
folded one update at a time (absorb) and fused pairwise (merge); Eq. 5's
ratio cancels any common normalization of the weights, so the fold is
order-free up to float rounding.  The planes are flat ``(N,)`` float32
vectors over the sorted-key leaves, so an absorb is one ``aio_absorb``
launch and a merge one ``aio_merge`` launch, both in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.utils.pytree import (flat_vector, flatten_to_vector,
                                      split_vector, tree_leaves, tree_size)

PyTree = Any
F32 = torch.float32


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as the reference's: the
    CPU build's float32 ``torch.sqrt`` is one ulp off for some inputs
    (0.0667 among them).  Taken in float64, whose rounding to float32 is
    exact for a square root."""
    return torch.sqrt(x.double()).to(F32)


def divergence_factor(alpha, beta) -> torch.Tensor:
    """(1 - alpha(2-alpha)sqrt(beta)) — the Lemma-1 contraction factor."""
    alpha = torch.as_tensor(alpha, dtype=F32)
    beta = torch.as_tensor(beta, dtype=F32)
    return 1.0 - alpha * (2.0 - alpha) * sqrt_f32(beta)


def sum_left_to_right(x: torch.Tensor) -> torch.Tensor:
    """The float32 sum of a short vector taken left to right, the order of
    the reference's reduction for cohorts of up to 32 updates."""
    total = x[0]
    for v in x[1:]:
        total = total + v
    return total


def optimal_coefficients(alphas, betas) -> torch.Tensor:
    """Theorem 1 (Eq. 13): p* minimizing the global divergence bound,
    normalized by :func:`sum_left_to_right`."""
    d = divergence_factor(alphas, betas)
    inv = 1.0 / torch.clamp(d.square(), min=1e-12)
    return inv / sum_left_to_right(inv)


def fedavg_coefficients(data_sizes) -> torch.Tensor:
    """Conventional FedAvg weights |D_i|/|D| (the w/o-AIO ablation)."""
    d = torch.as_tensor(data_sizes, dtype=F32)
    return d / d.sum()


def aio_aggregate(updates: Sequence[PyTree], masks: Sequence[PyTree],
                  weights: torch.Tensor) -> PyTree:
    """Eq. 5 over pytrees. updates/masks: per-device, same structure."""
    flat = [flatten_to_vector(u) for u in updates]
    unflatten = flat[0][1]
    u = torch.stack([v for v, _ in flat])
    m = torch.stack([flatten_to_vector(x)[0] for x in masks])
    w = torch.as_tensor(weights, dtype=F32).to(u.device)
    return unflatten(ops.aio_aggregate_op(u, m, w))


def aio_aggregate_stacked(u: torch.Tensor, m: torch.Tensor,
                          weights) -> torch.Tensor:
    """Eq. 5 in vector form. u, m: (I, N); weights: (I,) -> (N,)."""
    w = torch.as_tensor(weights, dtype=F32).to(u.device)
    return ops.aio_aggregate_op(u, m, w)


# --------------------------------------------------------------- PartialAgg

@dataclasses.dataclass
class PartialAgg:
    """Unnormalized AIO running sums over the flattened coordinates.

    ``num``/``den`` are flat ``(N,)`` float32 planes in the sorted-key
    leaf order of ``template``, whose structure and leaf shapes they
    follow.  ``count`` is how many updates were folded in (bookkeeping
    only: it does not enter the math)."""
    num: torch.Tensor
    den: torch.Tensor
    template: PyTree
    count: int = 0


def partial_init(template: PyTree) -> PartialAgg:
    """The monoid identity: all-zero planes on ``template``'s device."""
    dev = tree_leaves(template)[0].device
    num = torch.zeros(tree_size(template), dtype=F32, device=dev)
    return PartialAgg(num=num, den=torch.zeros_like(num), template=template)


def absorb_trees(num: torch.Tensor, den: torch.Tensor, values: PyTree,
                 mask: PyTree, weight: float) -> None:
    """The absorb rule, IN PLACE on the flat planes: ``num += w*m*u``,
    ``den += w*m``, one ``aio_absorb`` launch.  ``values``/``mask`` are
    read as flat vectors without a copy when their leaves tile one
    buffer (as ``AnycostClient.finish_round`` leaves them)."""
    ops.aio_absorb_op(num, den, flat_vector(values), flat_vector(mask),
                      weight)


def partial_absorb(part: PartialAgg, values: PyTree, mask: PyTree,
                   weight: float) -> None:
    """Fold one device update into ``part`` in place.  ``weight`` is the
    device's *unnormalized* coefficient (Eq. 5's ratio cancels any
    common normalization)."""
    absorb_trees(part.num, part.den, values, mask, weight)
    part.count += 1


def merge_trees(num_a: torch.Tensor, den_a: torch.Tensor,
                num_b: torch.Tensor, den_b: torch.Tensor) -> None:
    """The merge rule, IN PLACE on the a-side planes: ``num_a += num_b``,
    ``den_a += den_b``, one ``aio_merge`` launch."""
    ops.aio_merge_op(num_a, den_a, num_b, den_b)


def partial_merge(a: PartialAgg, b: PartialAgg) -> None:
    """Fuse ``b`` into ``a`` in place (commutative and associative up to
    float rounding); ``b`` is left as it was."""
    merge_trees(a.num, a.den, b.num, b.den)
    a.count += b.count


def finalize_trees(num: torch.Tensor, den: torch.Tensor,
                   template: PyTree) -> PyTree:
    """Eq. 5's ratio over the flat planes, ``num/den`` where any device
    covered the coordinate and 0 elsewhere, as a pytree shaped like
    ``template`` (plain PyTorch: the reference computes it outside any
    kernel)."""
    zero = torch.zeros((), dtype=F32, device=num.device)
    agg = torch.where(den > 0, num / torch.clamp(den, min=1e-12), zero)
    return split_vector(template, agg)


def partial_finalize(part: PartialAgg) -> PyTree:
    """Eq. 5's ratio of a partial, shaped like its template."""
    return finalize_trees(part.num, part.den, part.template)


def alignment_stats(a: PyTree, b: PyTree) -> tuple:
    """(cosine, relative L2 distance ``||a - b|| / ||b||``) between two
    update pytrees, as 0-d float32 tensors; each is 0 where a norm it
    divides by is 0.  Per-leaf float32 sums, added over the leaves left
    to right in sorted-key order, as the reference folds them."""
    la = [x.float().reshape(-1) for x in tree_leaves(a)]
    lb = [y.float().reshape(-1) for y in tree_leaves(b)]

    def fold(parts):
        total = parts[0]
        for x in parts[1:]:
            total = total + x
        return total

    dot = fold([torch.dot(x, y) for x, y in zip(la, lb)])
    na = torch.sqrt(fold([x.square().sum() for x in la]))
    nb = torch.sqrt(fold([y.square().sum() for y in lb]))
    diff = torch.sqrt(fold([(x - y).square().sum() for x, y in zip(la, lb)]))
    zero = torch.zeros((), dtype=F32, device=dot.device)
    cos = torch.where((na > 0) & (nb > 0),
                      dot / torch.clamp(na * nb, min=1e-30), zero)
    rel = torch.where(nb > 0, diff / torch.clamp(nb, min=1e-30), zero)
    return cos, rel
