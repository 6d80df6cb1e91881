"""Arrival/aggregation policies: ``sync``, ``semisync``, ``fedbuff``.

One interface, three server behaviours:

* :class:`SyncPolicy` — the paper's lock-step round: the server (or, in a
  hierarchical topology, each edge) barriers on every dispatched client
  and the round lasts ``max_i (T_cmp_i + T_com_i)``.
* :class:`SemiSyncPolicy` — the server aggregates at a hard deadline
  (default: the fleet's shared ``T_max``); clients that finish late are
  either dropped or down-weighted.  With a non-binding deadline this is
  exactly ``sync``.
* :class:`FedBuffPolicy` — fully asynchronous buffered aggregation
  (FedBuff-style): updates stream in, the server merges every ``K``
  arrivals with the element-wise AIO rule, scaling each update's
  coefficient by a staleness discount ``(1 + s)^-gamma``.

All three use the synchronous loop's coefficients (Theorem 1 for
AnycostFL, FedHQ's or FedAvg's for the baselines): round-based merges
through the normalized :func:`base_weights`, the hierarchical edge fold
and fedbuff's streaming accumulator through :func:`unnormalized_weight`
(times the staleness discount; Eq. 5's ratio cancels the normalization).
A policy only decides *which* updates enter the merge, *at what
simulated time*, and with *what scale factors*.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import aggregation
from repro_torch.train.baselines import fedhq_weights

POLICIES = ("sync", "semisync", "fedbuff")

# straggler handling for semisync
DROP = "drop"
DOWNWEIGHT = "downweight"

# staleness-cap handling for fedbuff
STALE_DROP = "drop"          # discard the update; the client's automatic
                             # re-dispatch trains fresh data on the new model
STALE_REQUEUE = "requeue"    # retrain the *same* minibatch draw against the
                             # current model version before dispatching fresh

# aggregation route of hierarchical round merges
AGG_ROUTES = ("streaming", "batched", "mesh")


@dataclasses.dataclass
class OrchestratorConfig:
    """Knobs of the discrete-event server (see module docstring)."""
    policy: str = "sync"
    # --- semisync
    deadline_s: Optional[float] = None     # None -> fleet T_max
    straggler_mode: str = DROP             # drop | downweight
    straggler_weight: float = 0.25         # scale in downweight mode
    # --- fedbuff
    buffer_size: int = 8                   # K updates per server merge
    staleness_exponent: float = 0.5        # w_i *= (1 + s_i)^-gamma
    staleness_cap: Optional[int] = None    # admission: reject staler updates
    staleness_mode: str = STALE_DROP       # drop | requeue
    retry_interval_s: Optional[float] = None   # infeasible-draw backoff
    max_inflight: Optional[int] = None     # cap concurrent dispatched
                                           # clients (fedbuff throttle)
    # --- hierarchical aggregation route -- streaming: per-cell edge fold
    # and cloud merge (aio_absorb / aio_merge, the wire codec's numerics);
    # batched: the flat (I, N) Eq. 5 over every accepted update
    # (aio_aggregate), backhaul costs still charged per cell; mesh: cells
    # over a mesh of devices (on one device it falls back to streaming)
    agg_route: str = "streaming"
    # --- stopping / execution
    max_wallclock_s: Optional[float] = None    # simulated seconds
    use_pool: Optional[bool] = None        # None -> policy default
    # --- event-trace retention: None keeps every popped record; N keeps
    # the newest N and folds the rest into a rolling hash
    event_trace_limit: Optional[int] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"expected one of {POLICIES}")
        if self.straggler_mode not in (DROP, DOWNWEIGHT):
            raise ValueError(
                f"unknown straggler_mode {self.straggler_mode!r}; "
                f"expected {DROP!r} or {DOWNWEIGHT!r}")
        if self.staleness_mode not in (STALE_DROP, STALE_REQUEUE):
            raise ValueError(
                f"unknown staleness_mode {self.staleness_mode!r}; "
                f"expected {STALE_DROP!r} or {STALE_REQUEUE!r}")
        if self.staleness_cap is not None and self.staleness_cap < 0:
            raise ValueError("staleness_cap must be >= 0")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if self.event_trace_limit is not None \
                and self.event_trace_limit < 1:
            raise ValueError("event_trace_limit must be >= 1 (or None "
                             "for unbounded retention)")
        if self.agg_route not in AGG_ROUTES:
            raise ValueError(f"unknown agg_route {self.agg_route!r}; "
                             f"expected one of {AGG_ROUTES}")


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
    """Rescale + renormalize — identity (bitwise) when every scale is 1.
    The sum runs left to right, as the reference's does for cohorts of up
    to 32 updates."""
    if all(s == 1.0 for s in scales):
        return weights
    w = weights * torch.as_tensor(scales, dtype=torch.float32)
    return w / aggregation.sum_left_to_right(w)


def staleness_scales(staleness: Sequence[int], gamma: float) -> list[float]:
    """FedBuff-style discount ``(1 + s)^-gamma`` per buffered update."""
    return [float((1.0 + float(s)) ** (-gamma)) for s in staleness]


def staleness_scaled_weights(base: torch.Tensor, staleness: Sequence[int],
                             gamma: float) -> torch.Tensor:
    """Staleness-discounted AIO coefficients, renormalized to sum to 1: a
    stale update keeps a strictly positive but strictly discounted
    share, so it cannot dominate the merge."""
    return apply_scales(base, staleness_scales(staleness, gamma))


class SyncPolicy:
    """Barrier on all dispatched clients (the paper's synchronous round)."""

    name = "sync"
    round_based = True
    pool_default = False      # per-client training, the reference's order

    def __init__(self, cfg: OrchestratorConfig):
        self.cfg = cfg

    def accept(self, completions, round_start: float):
        """All updates accepted; the round lasts until the last arrival.

        Works on per-client *durations* (relative to the round start) so a
        late round's latency is the same float as round 0's would be."""
        lat = max((c.duration for c in completions), default=0.0)
        return list(completions), [1.0] * len(completions), lat


class SemiSyncPolicy:
    """Hard deadline cutoff; stragglers dropped or down-weighted.

    ``downweight`` merges a late update *at the deadline* with a
    discounted weight, as a proxy for the server folding it in when it
    lands: time-to-accuracy under it is optimistic by up to one
    straggler flight; ``drop`` keeps the timeline causal."""

    name = "semisync"
    round_based = True
    pool_default = True

    def __init__(self, cfg: OrchestratorConfig, *, fleet_T_max: float):
        self.cfg = cfg
        self.deadline = cfg.deadline_s if cfg.deadline_s is not None \
            else fleet_T_max

    def accept(self, completions, round_start: float):
        on_time = [c for c in completions if c.duration <= self.deadline]
        late = [c for c in completions if c.duration > self.deadline]
        if not late:
            # non-binding deadline: exactly the sync barrier
            lat = max((c.duration for c in completions), default=0.0)
            return list(completions), [1.0] * len(completions), lat
        if self.cfg.straggler_mode == DROP:
            return on_time, [1.0] * len(on_time), self.deadline
        accepted = on_time + late
        scales = [1.0] * len(on_time) + \
            [self.cfg.straggler_weight] * len(late)
        return accepted, scales, self.deadline


class FedBuffPolicy:
    """Buffered fully-async aggregation with staleness-discounted weights."""

    name = "fedbuff"
    round_based = False
    pool_default = True

    def __init__(self, cfg: OrchestratorConfig):
        self.cfg = cfg

    def should_aggregate(self, buffer) -> bool:
        return len(buffer) >= self.cfg.buffer_size

    def admit(self, staleness: int) -> bool:
        """Staleness-cap admission: an update whose model version lags the
        server by more than the cap never enters the buffer; the runner
        then re-dispatches the client (``drop``) or retrains the rejected
        round's minibatches on the current version (``requeue``)."""
        return self.cfg.staleness_cap is None \
            or staleness <= self.cfg.staleness_cap


def make_policy(cfg: OrchestratorConfig, *, fleet_T_max: float):
    if cfg.policy == "sync":
        return SyncPolicy(cfg)
    if cfg.policy == "semisync":
        return SemiSyncPolicy(cfg, fleet_T_max=fleet_T_max)
    return FedBuffPolicy(cfg)
