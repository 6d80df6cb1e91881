"""Arrival/aggregation policies: the paper's synchronous round.

:class:`SyncPolicy` — the server (or, in a hierarchical topology, each
edge) barriers on every dispatched client and the round lasts
``max_i (T_cmp_i + T_com_i)``.  ``semisync`` and ``fedbuff`` are named so
that a config asking for them fails loudly; they arrive with ROADMAP
queue 1's 'Semisync and fedbuff' item.  The flat round normalizes its
coefficients (:func:`base_weights`, by method and ``use_aio``); the
hierarchical edge fold absorbs each update with its
:func:`unnormalized_weight`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import aggregation
from repro_torch.train.baselines import fedhq_weights

POLICIES = ("sync", "semisync", "fedbuff")
# aggregation route of hierarchical round merges
AGG_ROUTES = ("streaming", "batched", "mesh")


@dataclasses.dataclass
class OrchestratorConfig:
    """Knobs of the discrete-event server."""
    policy: str = "sync"
    # hierarchical aggregation route -- streaming: per-cell edge fold and
    # cloud merge (aio_absorb / aio_merge, the wire codec's numerics);
    # batched: the flat (I, N) Eq. 5 over every accepted update
    # (aio_aggregate), backhaul costs still charged per cell
    agg_route: str = "streaming"

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"expected one of {POLICIES}")
        if self.policy != "sync":
            raise NotImplementedError(
                f"policy {self.policy!r}: the port runs the sync policy "
                f"only; ROADMAP queue 1 'Semisync and fedbuff' brings it")
        if self.agg_route not in AGG_ROUTES:
            raise ValueError(f"unknown agg_route {self.agg_route!r}; "
                             f"expected one of {AGG_ROUTES}")
        if self.agg_route == "mesh":
            raise NotImplementedError(
                "agg_route 'mesh': cells over a mesh of cards is not "
                "ported; ROADMAP queue 1, 'Pod path', brings it")


def base_weights(method: str, use_aio: bool, updates: Sequence,
                 fedhq_L: Sequence[int]) -> torch.Tensor:
    """The synchronous loop's aggregation coefficients: AnycostFL's
    Theorem-1 weights, FedHQ's noise-bound weights (``fedhq_L``: each
    update's level count, read for FedHQ only), else FedAvg's
    sample-count weights (the other baselines and the w/o-AIO
    ablation)."""
    if method == "anycostfl" and use_aio:
        return aggregation.optimal_coefficients(
            [u.alpha for u in updates],
            [max(u.beta_target, 1e-6) for u in updates])
    if method == "fedhq":
        return fedhq_weights(list(fedhq_L))
    return aggregation.fedavg_coefficients([u.n_samples for u in updates])


def unnormalized_weight(method: str, use_aio: bool, update,
                        fedhq_level: Optional[int] = None) -> float:
    """One update's :func:`base_weights` coefficient without the cohort
    sum, as the streaming AIO monoid needs it (Eq. 5's ratio cancels the
    normalization).  Theorem 1: ``1 / max(d^2, 1e-12)`` with d the
    float32 divergence factor, the rest in Python floats as in the
    reference."""
    if method == "anycostfl" and use_aio:
        d = float(aggregation.divergence_factor(
            update.alpha, max(update.beta_target, 1e-6)))
        return 1.0 / max(d * d, 1e-12)
    if method == "fedhq":
        L = int(fedhq_level)
        return 1.0 / (1.0 + 1.0 / (4.0 * L * L))
    return float(update.n_samples)


def apply_scales(weights: torch.Tensor,
                 scales: Sequence[float]) -> torch.Tensor:
    """Rescale + renormalize — identity (bitwise) when every scale is 1."""
    if all(s == 1.0 for s in scales):
        return weights
    w = weights * torch.as_tensor(scales, dtype=torch.float32)
    return w / w.sum()


class SyncPolicy:
    """Barrier on all dispatched clients (the paper's synchronous round)."""

    name = "sync"

    def __init__(self, cfg: OrchestratorConfig):
        self.cfg = cfg

    def accept(self, completions, round_start: float):
        """All updates accepted; the round lasts until the last arrival.

        Works on per-client *durations* (relative to the round start) so a
        late round's latency is the same float as round 0's would be."""
        lat = max((c.duration for c in completions), default=0.0)
        return list(completions), [1.0] * len(completions), lat
