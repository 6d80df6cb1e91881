"""Multi-round federated training loop (paper §V experiments).

Runs AnycostFL and the paper's comparison methods (:data:`METHODS`: STC,
QSGD, UVeQFed, HeteroFL, FedHQ and FedAvg, ``train/baselines.py``) over
the simulated heterogeneous fleet with real numerics on synthetic
class-conditional data; ``use_ems``/``use_fgc``/``use_aio`` switch off
one AnycostFL component each (the Fig. 5a ablations).  Tracks the
Table-I columns: rounds, energy (J), latency (s), compute (FLOPs),
communication (bits), test accuracy.  The round loop itself lives in
``orchestrator/runner.py``; this module keeps the public entry point
(``run_fl``: the synchronous policy unless an ``OrchestratorConfig``
asks for ``semisync`` or ``fedbuff``) and the config/log dataclasses
and helpers shared with it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import numpy as np
import torch

# AnycostClient/AnycostServer are re-exported, as the reference's module
# does (its benchmarks hook the server's aggregate through it)
from repro_torch.core.anycost import (AnycostClient, AnycostServer,  # noqa: F401
                                      DEFAULT_ALPHA_BUCKETS)
from repro_torch.models.registry import cls_loss
from repro_torch.sysmodel.population import FleetConfig

PyTree = Any

METHODS = ("anycostfl", "stc", "qsgd", "uveqfed", "heterofl", "fedhq",
           "fedavg")


@dataclasses.dataclass
class FLRunConfig:
    arch: str = "fmnist-cnn"
    method: str = "anycostfl"
    rounds: int = 30
    lr: float = 0.05
    batch_size: int = 32
    tau: float = 1.0
    seed: int = 0
    iid: bool = True
    dirichlet_alpha: float = 0.5
    n_train: int = 2048
    n_test: int = 512
    eval_every: int = 5
    # ablations (Fig. 5a)
    use_ems: bool = True
    use_fgc: bool = True
    use_aio: bool = True
    alpha_buckets: tuple = DEFAULT_ALPHA_BUCKETS
    use_planner: bool = True


# the registry namespace backing RoundLog views: every field of a round
# record is gauged as ``round.<field>`` with a ``round=<idx>`` label, and
# RoundLog.from_registry materializes the dataclass by reading those
# exact stored objects back (bitwise-identical round trip)
ROUND_METRIC_PREFIX = "round."

# the cost-attribution phases of the AnycostFL pipeline.  ``shrink``
# (EMS sub-model extraction) and ``compress`` (FGC encode) are explicit
# zeros under the paper's Eq. 6-9 cost model (their compute rides
# inside the train term), but the axis carries them so a finer cost
# model can populate them without a schema change.
PHASES = ("shrink", "train", "compress", "uplink", "backhaul")


@dataclasses.dataclass
class RoundLog:
    """One round's (or fedbuff merge's) record, a view over the run's
    ``MetricsRegistry`` (:meth:`from_registry`)."""
    round: int
    latency_s: float
    energy_j: float
    flops: float
    comm_bits: float
    mean_alpha: float
    mean_beta: float
    mean_gain: float
    test_acc: Optional[float] = None
    test_loss: Optional[float] = None
    t_wall: float = 0.0           # simulated wall-clock at round end
    n_clients: int = 0            # updates that entered the aggregation
    n_dropped: int = 0            # completed but rejected (semisync)
    mean_staleness: float = 0.0   # fedbuff: mean server-version lag
    max_staleness: int = 0        # fedbuff: worst admitted version lag
    n_stale_dropped: int = 0      # fedbuff: rejected by the staleness cap
    # fleet dynamics (0 / 1.0 on the static always-on roster)
    n_unavailable: int = 0        # off-cell or drained at dispatch time
    n_aborted: int = 0            # churned out of the cell mid-round
    mean_soc: float = 1.0         # the fleet's mean state of charge
    t_max_effective: float = 0.0  # T_max handed to the P4 solver
    # hierarchical topologies (0 on the flat path)
    n_cells_reporting: int = 0    # cells that shipped a partial
    backhaul_bits: float = 0.0    # edge->cloud bits this round
    # mobility (0 on a static fleet)
    n_handovers: int = 0          # devices re-homed at this round's start
    max_cell_occupancy: int = 0   # most devices bound to any one cell
    # per-phase split: energy sums to energy_j, latency to latency_s
    energy_train_j: float = 0.0
    energy_uplink_j: float = 0.0
    energy_backhaul_j: float = 0.0
    latency_train_s: float = 0.0   # critical path: slowest client's T_cmp
    latency_uplink_s: float = 0.0  # critical path: uplink + barrier wait
    latency_backhaul_s: float = 0.0  # critical path: the cell's shipping

    @classmethod
    def from_registry(cls, registry, round_idx: int) -> "RoundLog":
        """Materialize the round record from the exact objects gauged
        under ``round.<field>{round=round_idx}``; absent fields keep
        their defaults."""
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name == "round":
                continue
            v = registry.value(ROUND_METRIC_PREFIX + f.name,
                               round=round_idx)
            if v is not None:
                kw[f.name] = v
        return cls(round=round_idx, **kw)

    def phase_energy(self) -> dict:
        """``{phase: joules}`` over the full phase axis (sums to
        energy_j)."""
        return {"shrink": 0.0, "train": self.energy_train_j,
                "compress": 0.0, "uplink": self.energy_uplink_j,
                "backhaul": self.energy_backhaul_j}

    def phase_latency(self) -> dict:
        """``{phase: seconds}`` of the round's critical path (sums to
        latency_s on every policy)."""
        return {"shrink": 0.0, "train": self.latency_train_s,
                "compress": 0.0, "uplink": self.latency_uplink_s,
                "backhaul": self.latency_backhaul_s}

    def phase_comm(self) -> dict:
        """``{phase: bits}``: comm_bits is all uplink; backhaul traffic
        is the separate backhaul_bits."""
        return {"shrink": 0.0, "train": 0.0, "compress": 0.0,
                "uplink": self.comm_bits, "backhaul": 0.0}


@dataclasses.dataclass
class History:
    cfg: FLRunConfig
    rounds: list
    best_acc: float = 0.0
    trace: Optional[tuple] = None   # event-queue replay signature
    # (t, client_id, headroom_j) per successful dispatch
    dispatch_log: Optional[list] = None
    # fedbuff: most concurrent in-flight clients observed (audits the
    # --max-inflight throttle)
    peak_inflight: int = 0
    final_params: Optional[PyTree] = None   # the global model after the run
    # the MetricsRegistry backing every RoundLog in ``rounds``
    registry: Optional[Any] = None

    def log_round(self, round_idx: int, **fields) -> RoundLog:
        """Gauge every field into the registry, then append + return the
        :meth:`RoundLog.from_registry` view."""
        for name, value in fields.items():
            # the registry *is* the RoundLog storage: always live,
            # host-side, bitwise-invisible to training
            # repro: ignore[unguarded-telemetry] — RoundLog backing store
            self.registry.gauge(ROUND_METRIC_PREFIX + name, value,
                                round=round_idx)
        log = RoundLog.from_registry(self.registry, round_idx)
        self.rounds.append(log)
        return log

    def log_eval(self, log: RoundLog, acc: float, loss: float) -> None:
        """Attach an eval to a round record (registry + view + best)."""
        # repro: ignore[unguarded-telemetry] — RoundLog backing store
        self.registry.gauge(ROUND_METRIC_PREFIX + "test_acc", acc,
                            round=log.round)
        # repro: ignore[unguarded-telemetry] — RoundLog backing store
        self.registry.gauge(ROUND_METRIC_PREFIX + "test_loss", loss,
                            round=log.round)
        log.test_acc = acc
        log.test_loss = loss
        self.best_acc = max(self.best_acc, acc)

    def total_handovers(self) -> int:
        """Devices re-homed over the whole run."""
        return int(sum(r.n_handovers for r in self.rounds))

    def cumulative(self, field: str) -> np.ndarray:
        return np.cumsum([getattr(r, field) for r in self.rounds])

    def wallclock(self) -> float:
        """Simulated seconds at the end of the run."""
        return self.rounds[-1].t_wall if self.rounds else 0.0

    def time_to_acc(self, threshold: float) -> Optional[float]:
        """Simulated wall-clock of the first eval reaching ``threshold``."""
        for r in self.rounds:
            if r.test_acc is not None and r.test_acc >= threshold:
                return r.t_wall
        return None

    def to_rows(self) -> list[dict]:
        """Per-round records plus the cumulative cost columns."""
        out = []
        for r, (ct, ce, cf, cb) in zip(
                self.rounds, zip(self.cumulative("latency_s"),
                                 self.cumulative("energy_j"),
                                 self.cumulative("flops"),
                                 self.cumulative("comm_bits"))):
            row = dataclasses.asdict(r)
            row.update(cum_latency_s=float(ct), cum_energy_j=float(ce),
                       cum_flops=float(cf), cum_comm_bits=float(cb))
            out.append(row)
        return out

    def phase_totals(self) -> dict:
        """Whole-run per-phase attribution: ``{metric: {phase: total}}``
        over energy (J), latency (s, the critical path) and comm
        (bits)."""
        totals = {"energy_j": dict.fromkeys(PHASES, 0.0),
                  "latency_s": dict.fromkeys(PHASES, 0.0),
                  "comm_bits": dict.fromkeys(PHASES, 0.0)}
        for r in self.rounds:
            for phase, v in r.phase_energy().items():
                totals["energy_j"][phase] += v
            for phase, v in r.phase_latency().items():
                totals["latency_s"][phase] += v
            for phase, v in r.phase_comm().items():
                totals["comm_bits"][phase] += v
        return totals


def flops_per_sample(arch_cfg) -> float:
    """Training FLOPs (fwd+bwd ~ 3x fwd) per sample — the paper's W."""
    if arch_cfg.family != "cnn":
        # transformer-ish: 6 * params per token
        return 6.0 * arch_cfg.n_active_params()
    c = arch_cfg.d_model
    if arch_cfg.name.startswith("fmnist"):
        fwd = (28 * 28 * 5 * 5 * 1 * c + 14 * 14 * 5 * 5 * c * 2 * c
               + 7 * 7 * 2 * c * arch_cfg.d_ff
               + arch_cfg.d_ff * arch_cfg.vocab_size) * 2
    else:
        fwd = (32 * 32 * 9 * (3 * c + c * c) + 16 * 16 * 9 * (c * 2 * c + 4 * c * c)
               + 8 * 8 * 9 * (2 * c * 4 * c + 16 * c * c)
               + 16 * 4 * c * arch_cfg.d_ff + arch_cfg.d_ff * arch_cfg.d_ff
               + arch_cfg.d_ff * 10) * 2
    return 3.0 * fwd


def _make_eval(model, test_x: torch.Tensor, test_y: torch.Tensor):
    def ev(params):
        with torch.no_grad():
            logits = model.forward(params, {"images": test_x})
            acc = (logits.argmax(-1) == test_y).float().mean()
            return acc, cls_loss(logits, test_y)

    return ev


def _device_batches(rng: np.random.Generator, x: np.ndarray, y: np.ndarray,
                    idx: np.ndarray, batch_size: int, tau: float,
                    device) -> dict:
    """Stack tau-epoch minibatches -> (steps, B, ...) tensors on device."""
    n = len(idx)
    bs = min(batch_size, n)
    steps = max(int(round(tau * n / bs)), 1)
    order = np.concatenate([rng.permutation(n)
                            for _ in range(math.ceil(steps * bs / n) + 1)])
    sel = idx[order[:steps * bs]].reshape(steps, bs)
    return {"images": torch.from_numpy(x[sel]).to(device),
            "labels": torch.from_numpy(y[sel]).to(device)}


def run_fl(run_cfg: FLRunConfig, fleet_cfg: Optional[FleetConfig] = None,
           orch=None, *, device="cuda", verbose: bool = False,
           telemetry=None) -> "History":
    """Federated training on ``device`` (``cuda`` unless the caller asks
    for the CPU) under ``orch``, an ``OrchestratorConfig``; None is the
    paper's synchronous round.  ``telemetry`` is an optional
    ``repro_torch.telemetry.Telemetry`` session."""
    from repro_torch.orchestrator.runner import run_orchestrated
    return run_orchestrated(run_cfg, fleet_cfg, orch, device=device,
                            verbose=verbose, telemetry=telemetry)
