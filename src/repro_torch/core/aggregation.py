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
The streaming ``PartialAgg`` monoid arrives with the hierarchical path.
"""
from __future__ import annotations

from typing import Any, Sequence

import torch

from repro_torch.kernels import ops
from repro_torch.utils.pytree import flatten_to_vector

PyTree = Any
F32 = torch.float32


def divergence_factor(alpha, beta) -> torch.Tensor:
    """(1 - alpha(2-alpha)sqrt(beta)) — the Lemma-1 contraction factor."""
    alpha = torch.as_tensor(alpha, dtype=F32)
    beta = torch.as_tensor(beta, dtype=F32)
    return 1.0 - alpha * (2.0 - alpha) * torch.sqrt(beta)


def optimal_coefficients(alphas, betas) -> torch.Tensor:
    """Theorem 1 (Eq. 13): p* minimizing the global divergence bound."""
    d = divergence_factor(alphas, betas)
    inv = 1.0 / torch.clamp(d.square(), min=1e-12)
    return inv / inv.sum()


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
