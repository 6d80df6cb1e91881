"""Seeded device-availability traces (fleet dynamics, control plane).

A trace answers two questions about device ``i`` at simulated time ``t``:
is it in the cell right now (``available``), and when does its on/off
state next flip (``next_change``)?  The orchestrator uses the first to
gate dispatch and the second to schedule mid-round churn events into the
discrete-event heap (a device that leaves before its planned
``T_cmp + T_com`` elapses aborts the round).

Four generators:

* ``always``  — the static fleet of the paper's §V setup; consumes no
  randomness, so runs configured with it are bit-identical to runs with
  no trace attached.
* ``markov``  — per-device 2-state continuous-time Markov chain with
  exponential on/off holding times (the classic cellular-availability
  model); each device draws from its own ``default_rng([seed, i])``
  stream so traces replay identically per seed and are insensitive to
  query order.
* ``diurnal`` — deterministic day/night sinusoid: device ``i`` is on
  while ``sin(2*pi*t/period + phase_i) >= cos(pi*duty)``, which puts it
  in the cell for exactly a ``duty`` fraction of every period; phases
  are seeded per device so the fleet's load waxes and wanes smoothly.
* ``replay``  — on-intervals loaded from a JSON file (measured traces),
  cycled over the fleet when the file has fewer devices than the run.

All state is generated lazily and cached per device, so a trace can be
queried at any (monotone or not) sequence of times.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
from typing import Optional

import numpy as np

KINDS = ("always", "markov", "diurnal", "replay")


@dataclasses.dataclass
class AvailabilityConfig:
    """Knobs for :func:`make_trace` (fields are per-kind; extras ignored)."""
    kind: str = "always"
    seed: int = 0
    # markov
    mean_on_s: float = 30.0
    mean_off_s: float = 15.0
    # diurnal
    period_s: float = 120.0
    duty: float = 0.6
    # replay
    trace_file: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown availability kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "replay" and self.trace_file is None:
            raise ValueError("replay availability needs trace_file")


class AvailabilityTrace:
    """Interface: on/off state of every device over simulated time."""

    def available(self, i: int, t: float) -> bool:
        raise NotImplementedError

    def next_change(self, i: int, t: float) -> float:
        """Time of the first state flip strictly after ``t`` (inf if none)."""
        raise NotImplementedError


class AlwaysOn(AvailabilityTrace):
    """The static fleet: every device in the cell forever."""

    def available(self, i: int, t: float) -> bool:
        return True

    def next_change(self, i: int, t: float) -> float:
        return math.inf


class MarkovTrace(AvailabilityTrace):
    """Per-device 2-state on/off chain with exponential holding times."""

    def __init__(self, n_devices: int, seed: int = 0,
                 mean_on_s: float = 30.0, mean_off_s: float = 15.0):
        if mean_on_s <= 0 or mean_off_s <= 0:
            raise ValueError("markov holding-time means must be positive")
        self.mean_on = float(mean_on_s)
        self.mean_off = float(mean_off_s)
        self._rngs = [np.random.default_rng([seed, i])
                      for i in range(n_devices)]
        # stationary start: P(on) = mean_on / (mean_on + mean_off)
        p_on = self.mean_on / (self.mean_on + self.mean_off)
        self._state0 = [bool(r.random() < p_on) for r in self._rngs]
        self._flips: list[list[float]] = [[] for _ in range(n_devices)]

    def _segment_state(self, i: int, k: int) -> bool:
        return self._state0[i] ^ (k % 2 == 1)

    def _extend(self, i: int, t: float) -> None:
        flips = self._flips[i]
        while (flips[-1] if flips else 0.0) <= t:
            k = len(flips)
            mean = self.mean_on if self._segment_state(i, k) \
                else self.mean_off
            dur = max(float(self._rngs[i].exponential(mean)), 1e-3)
            flips.append((flips[-1] if flips else 0.0) + dur)

    def available(self, i: int, t: float) -> bool:
        self._extend(i, t)
        return self._segment_state(i, bisect.bisect_right(self._flips[i], t))

    def next_change(self, i: int, t: float) -> float:
        self._extend(i, t)
        flips = self._flips[i]
        return flips[bisect.bisect_right(flips, t)]


class DiurnalTrace(AvailabilityTrace):
    """Deterministic sinusoidal duty cycle with seeded per-device phase."""

    def __init__(self, n_devices: int, seed: int = 0,
                 period_s: float = 120.0, duty: float = 0.6):
        if period_s <= 0:
            raise ValueError("diurnal period must be positive")
        if not 0.0 < duty:
            raise ValueError("diurnal duty must be > 0")
        self.period = float(period_s)
        self.duty = float(duty)
        rng = np.random.default_rng([seed, 0x0D1])
        self._phase = rng.uniform(0.0, 2.0 * math.pi, n_devices)
        # on while sin(x) >= c; c = cos(pi*duty) makes the on-fraction = duty
        self._c = math.cos(math.pi * min(duty, 1.0))
        self._a = math.asin(max(-1.0, min(1.0, self._c)))

    def _x(self, i: int, t: float) -> float:
        return 2.0 * math.pi * t / self.period + float(self._phase[i])

    def available(self, i: int, t: float) -> bool:
        if self.duty >= 1.0:
            return True
        return math.sin(self._x(i, t)) >= self._c

    def next_change(self, i: int, t: float) -> float:
        if self.duty >= 1.0:
            return math.inf
        x = self._x(i, t)
        # boundaries: x = a (off->on) and x = pi - a (on->off), mod 2*pi
        best = math.inf
        for b in (self._a, math.pi - self._a):
            m = math.floor((x - b) / (2.0 * math.pi))
            for k in (m, m + 1, m + 2):
                xb = b + 2.0 * math.pi * k
                if xb > x + 1e-9:
                    best = min(best, xb)
                    break
        return (best - float(self._phase[i])) * self.period \
            / (2.0 * math.pi)


class ReplayTrace(AvailabilityTrace):
    """On-intervals per device from a recorded trace, cycled over the fleet.

    JSON shape: ``{"devices": [[[start, end], ...], ...]}`` (a bare list of
    per-device interval lists is accepted too). Intervals are half-open
    ``[start, end)`` in simulated seconds; outside every interval the
    device is off.

    The unified mobility scenario schema
    (:mod:`repro_torch.mobility.scenario`) also loads directly: device entries
    may be dicts carrying an ``"on"`` interval list next to their
    waypoints, and a device without one is always-on — so a single
    ``--scenario-trace`` file can drive positions *and* availability.
    """

    def __init__(self, intervals: list[list[tuple[float, float]]],
                 n_devices: int):
        if not intervals:
            raise ValueError("replay trace has no devices")
        self._iv = []
        for i in range(n_devices):
            iv = sorted((float(s), float(e))
                        for s, e in intervals[i % len(intervals)])
            # merge contiguous/overlapping intervals so every remaining
            # boundary is a genuine state flip (next_change contract)
            merged: list[list[float]] = []
            for s, e in iv:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._iv.append([(s, e) for s, e in merged])

    @classmethod
    def from_file(cls, path: str, n_devices: int) -> "ReplayTrace":
        raw = json.load(open(path))
        if isinstance(raw, dict):
            raw = raw["devices"]
        if raw and isinstance(raw[0], dict):
            # unified scenario schema: per-device dicts with an optional
            # "on" section (missing -> always on)
            raw = [d.get("on") if d.get("on") is not None
                   else [[0.0, math.inf]] for d in raw]
        return cls(raw, n_devices)

    def available(self, i: int, t: float) -> bool:
        return any(s <= t < e for s, e in self._iv[i])

    def next_change(self, i: int, t: float) -> float:
        best = math.inf
        for s, e in self._iv[i]:
            for b in (s, e):
                if b > t:
                    best = min(best, b)
        return best


def make_trace(cfg: AvailabilityConfig, n_devices: int) -> AvailabilityTrace:
    if cfg.kind == "always":
        return AlwaysOn()
    if cfg.kind == "markov":
        return MarkovTrace(n_devices, seed=cfg.seed,
                           mean_on_s=cfg.mean_on_s,
                           mean_off_s=cfg.mean_off_s)
    if cfg.kind == "diurnal":
        return DiurnalTrace(n_devices, seed=cfg.seed,
                            period_s=cfg.period_s, duty=cfg.duty)
    return ReplayTrace.from_file(cfg.trace_file, n_devices)
