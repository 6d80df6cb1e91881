"""Per-device state-of-charge model (fleet dynamics, control plane).

Each device carries a battery of ``capacity_j`` joules.  Every dispatch
debits the realized round energy ``E_cmp + E_com`` from ``sysmodel``
Eq. 7/9 (the orchestrator calls :meth:`debit`); between touches the
battery trickle-recharges at ``recharge_w`` watts (lazy: state is synced
to the queried simulated time on access, so both the round-based and the
event-driven fedbuff timelines share one model).

A device below its reserve cannot be dispatched — and, crucially, its
*headroom* above the reserve clamps the per-round energy budget the
Problem-(P4) solver sees, turning the paper's static ``E_max`` draw into
a dynamic budget: a draining device solves for smaller (alpha, beta, f)
before it disappears entirely.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class BatteryConfig:
    capacity_j: float = 60.0          # full charge, joules
    init_frac: tuple = (0.5, 1.0)     # initial SoC ~ U[lo, hi] * capacity
    recharge_w: float = 0.05          # trickle, joules / simulated second
    reserve_frac: float = 0.1         # SoC floor a device will not dip below
    min_headroom_j: float = 0.5       # headroom needed to accept a dispatch
    seed: int = 0

    def __post_init__(self):
        if self.capacity_j <= 0:
            raise ValueError("battery capacity must be positive")
        if not 0.0 <= self.reserve_frac < 1.0:
            raise ValueError("reserve_frac must be in [0, 1)")
        if self.reserve_frac * self.capacity_j + self.min_headroom_j \
                > self.capacity_j:
            raise ValueError(
                "reserve + min_headroom exceed capacity: a full battery "
                "could never be dispatched (ready_time would spin)")


class BatteryState:
    """Mutable per-fleet SoC vector with lazy trickle recharge."""

    def __init__(self, cfg: BatteryConfig, n_devices: int):
        self.cfg = cfg
        rng = np.random.default_rng([cfg.seed, 0xBA7])
        lo, hi = cfg.init_frac
        self.soc = rng.uniform(lo, hi, n_devices) * cfg.capacity_j
        self._last_t = np.zeros(n_devices)
        self.reserve_j = cfg.reserve_frac * cfg.capacity_j

    def _sync(self, i: int, t: float) -> None:
        dt = t - self._last_t[i]
        if dt > 0:
            self.soc[i] = min(self.cfg.capacity_j,
                              self.soc[i] + self.cfg.recharge_w * dt)
            self._last_t[i] = t

    def soc_at(self, i: int, t: float) -> float:
        self._sync(i, t)
        return float(self.soc[i])

    def headroom(self, i: int, t: float) -> float:
        """Joules spendable this dispatch without dipping below reserve."""
        return max(0.0, self.soc_at(i, t) - self.reserve_j)

    def available(self, i: int, t: float) -> bool:
        return self.headroom(i, t) >= self.cfg.min_headroom_j

    def debit(self, i: int, energy_j: float, t: float) -> None:
        """Spend a realized round's energy; SoC is floored at zero."""
        self._sync(i, t)
        self.soc[i] = max(0.0, self.soc[i] - max(0.0, energy_j))

    def ready_time(self, i: int, t: float) -> float:
        """Earliest time the device is dispatchable again (inf if never)."""
        if self.available(i, t):
            return t
        if self.cfg.recharge_w <= 0:
            return math.inf
        deficit = (self.reserve_j + self.cfg.min_headroom_j
                   - self.soc_at(i, t))
        return t + deficit / self.cfg.recharge_w

    def mean_soc_frac(self, t: float) -> float:
        for i in range(len(self.soc)):
            self._sync(i, t)
        return float(np.mean(self.soc)) / self.cfg.capacity_j
