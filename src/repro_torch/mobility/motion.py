"""Seeded device-motion models over continuous simulated time.

AnycostFL targets *mobile* edge devices, but the paper's §V setup only
approximates motion by re-dropping positions uniformly every round.  This
module supplies genuine trajectories: each device carries a 2-D position
``p_i(t)`` evolved by a seeded motion model, and the wireless layer
derives Eq.-8 path gain from the *true distance to the serving cell
site* instead of a fresh i.i.d. drop (see
``sysmodel.population.Fleet.round_envs``).

Four models behind one interface (:class:`MotionModel`):

* ``static``          — no motion model is ever constructed; the fleet
  keeps the paper's per-round re-drop path bit for bit.
  :func:`make_motion` returns ``None``.
* ``random_waypoint`` — the classic RWP: pick a waypoint uniformly in
  the disc, travel at a speed drawn from ``speed_range``, pause, repeat.
  An optional *hotspot* biases a fraction of waypoint draws into a small
  sub-disc, producing the skewed spatial load the load-balanced handover
  policy is built for.
* ``gauss_markov``    — temporally correlated velocity: speed and
  heading follow an AR(1) with memory ``gm_alpha`` updated every
  ``tick_s`` seconds, reflected at the area boundary (no border
  clustering); positions between ticks interpolate linearly.
* ``replay``          — piecewise-linear waypoints loaded from the
  unified scenario trace (:mod:`repro_torch.mobility.scenario`).

Determinism: every device draws from its own
``default_rng([seed, MOTION_STREAM, i])`` stream and segments/ticks are
extended lazily, so positions are a pure function of ``(seed, i, t)`` —
insensitive to query order, identical across runs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

KINDS = ("static", "random_waypoint", "gauss_markov", "replay")

# decorrelates motion streams from every other [seed, i] consumer
# (availability traces, batteries) that hashes the same seed
_MOTION_STREAM = 0x0B11E


@dataclasses.dataclass
class MobilityConfig:
    """Knobs for :func:`make_motion` (fields are per-kind; extras ignored)."""
    kind: str = "static"
    seed: int = 0
    # area the devices roam: a disc of this radius centred on the macro
    # cell site; None -> the fleet's wireless cell_radius_m
    area_radius_m: Optional[float] = None
    # random_waypoint
    speed_range: tuple = (1.0, 15.0)       # m/s (pedestrian..vehicular)
    pause_range: tuple = (0.0, 5.0)        # s at each waypoint
    hotspot: Optional[tuple] = None        # (x, y) waypoint-bias centre
    hotspot_frac: float = 0.0              # fraction of biased waypoints
    hotspot_radius_m: Optional[float] = None   # None -> area/4
    # gauss_markov
    tick_s: float = 1.0                    # velocity-update interval
    gm_alpha: float = 0.85                 # AR(1) memory in [0, 1)
    mean_speed: float = 5.0                # m/s
    speed_sigma: float = 2.0               # m/s
    # replay
    scenario_file: Optional[str] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown mobility kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "replay" and self.scenario_file is None:
            raise ValueError("replay mobility needs scenario_file")
        if not 0.0 <= self.hotspot_frac <= 1.0:
            raise ValueError("hotspot_frac must be in [0, 1]")
        if self.kind == "random_waypoint" \
                and self.speed_range[0] <= 0.0:
            raise ValueError("random_waypoint speeds must be positive")
        if self.kind == "gauss_markov" and not 0.0 <= self.gm_alpha < 1.0:
            raise ValueError("gauss_markov gm_alpha must be in [0, 1)")


class MotionModel:
    """Interface: per-device 2-D position over continuous simulated time."""

    n_devices: int

    def position(self, i: int, t: float) -> np.ndarray:
        """(2,) position of device ``i`` at simulated time ``t >= 0``."""
        raise NotImplementedError

    def positions_at(self, t: float) -> np.ndarray:
        """(I, 2) fleet snapshot at time ``t``."""
        return np.stack([self.position(i, t)
                         for i in range(self.n_devices)])


def _uniform_disc(rng: np.random.Generator, radius: float,
                  centre: Sequence[float] = (0.0, 0.0)) -> np.ndarray:
    r = radius * math.sqrt(rng.uniform())
    th = rng.uniform(0.0, 2.0 * math.pi)
    return np.array([centre[0] + r * math.cos(th),
                     centre[1] + r * math.sin(th)])


class RandomWaypoint(MotionModel):
    """Waypoint legs + pauses, lazily extended per device.

    Segments are ``(t0, t1, p0, p1)`` with linear travel from ``p0`` at
    ``t0`` to ``p1`` at ``t1`` (a pause is a zero-length leg).  The
    optional hotspot redraws a ``hotspot_frac`` share of waypoints inside
    a small disc around ``hotspot`` — the skewed scenario for the
    load-balanced handover study.
    """

    def __init__(self, n_devices: int, area_radius_m: float,
                 cfg: MobilityConfig):
        self.n_devices = n_devices
        self.area = float(area_radius_m)
        self.cfg = cfg
        self._rngs = [np.random.default_rng([cfg.seed, _MOTION_STREAM, i])
                      for i in range(n_devices)]
        self._segs: list[list[tuple]] = []
        for r in self._rngs:
            p0 = _uniform_disc(r, self.area)
            self._segs.append([(0.0, 0.0, p0, p0)])

    def _next_waypoint(self, rng: np.random.Generator) -> np.ndarray:
        c = self.cfg
        if c.hotspot is not None and rng.uniform() < c.hotspot_frac:
            hr = c.hotspot_radius_m if c.hotspot_radius_m is not None \
                else self.area / 4.0
            p = _uniform_disc(rng, hr, c.hotspot)
            # keep the biased draw inside the roaming disc
            n = float(np.linalg.norm(p))
            if n > self.area:
                p = p * (self.area / n)
            return p
        return _uniform_disc(rng, self.area)

    def _extend(self, i: int, t: float) -> None:
        segs, rng, c = self._segs[i], self._rngs[i], self.cfg
        while segs[-1][1] <= t:
            t1, p1 = segs[-1][1], segs[-1][3]
            wp = self._next_waypoint(rng)
            speed = rng.uniform(*c.speed_range)
            travel = float(np.linalg.norm(wp - p1)) / speed
            segs.append((t1, t1 + max(travel, 1e-9), p1, wp))
            pause = rng.uniform(*c.pause_range)
            if pause > 0:
                te = segs[-1][1]
                segs.append((te, te + pause, wp, wp))

    def position(self, i: int, t: float) -> np.ndarray:
        self._extend(i, t)
        for t0, t1, p0, p1 in reversed(self._segs[i]):
            if t0 <= t:
                frac = 0.0 if t1 <= t0 else min(1.0, (t - t0) / (t1 - t0))
                return p0 + frac * (p1 - p0)
        return self._segs[i][0][2]


class GaussMarkov(MotionModel):
    """AR(1)-correlated speed/heading on a fixed tick, reflected at the
    boundary; positions interpolate linearly between ticks."""

    def __init__(self, n_devices: int, area_radius_m: float,
                 cfg: MobilityConfig):
        self.n_devices = n_devices
        self.area = float(area_radius_m)
        self.cfg = cfg
        self._rngs = [np.random.default_rng([cfg.seed, _MOTION_STREAM, i])
                      for i in range(n_devices)]
        # per-device tick state: positions[k] at t = k * tick_s
        self._pos: list[list[np.ndarray]] = []
        self._speed: list[float] = []
        self._theta: list[float] = []
        for r in self._rngs:
            self._pos.append([_uniform_disc(r, self.area)])
            self._speed.append(max(0.0, float(
                r.normal(cfg.mean_speed, cfg.speed_sigma))))
            self._theta.append(float(r.uniform(0.0, 2.0 * math.pi)))

    def _step(self, i: int) -> None:
        c, rng = self.cfg, self._rngs[i]
        a = c.gm_alpha
        noise = math.sqrt(max(1.0 - a * a, 0.0))
        s = max(0.0, a * self._speed[i] + (1.0 - a) * c.mean_speed
                + noise * c.speed_sigma * float(rng.normal()))
        # heading mean-reverts to itself: a correlated random walk whose
        # step variance shrinks as the memory grows
        th = self._theta[i] + noise * 0.5 * float(rng.normal())
        p = self._pos[i][-1] + c.tick_s * s * np.array(
            [math.cos(th), math.sin(th)])
        n = float(np.linalg.norm(p))
        if n > self.area:
            # reflect the overshoot back into the disc and bounce the
            # heading so the walker leaves the boundary
            p = p * ((2.0 * self.area - n) / n) if n < 2.0 * self.area \
                else p * (self.area / n)
            th = th + math.pi
        self._speed[i], self._theta[i] = s, th % (2.0 * math.pi)
        self._pos[i].append(p)

    def position(self, i: int, t: float) -> np.ndarray:
        k = t / self.cfg.tick_s
        k0 = int(math.floor(k))
        while len(self._pos[i]) <= k0 + 1:
            self._step(i)
        p0, p1 = self._pos[i][k0], self._pos[i][k0 + 1]
        return p0 + (k - k0) * (p1 - p0)


class ReplayMobility(MotionModel):
    """Piecewise-linear waypoint replay from a recorded scenario trace.

    ``waypoints``: per device, a time-sorted list of ``(t, x, y)``
    samples; positions interpolate linearly between samples and clamp to
    the first/last sample outside the recorded span.  Devices cycle over
    the recorded set when the run has more devices than the trace (same
    convention as :class:`repro_torch.fleet.ReplayTrace`).
    """

    def __init__(self, waypoints: list[list[tuple]], n_devices: int):
        if not waypoints or any(not w for w in waypoints):
            raise ValueError("replay mobility needs >= 1 waypoint per "
                             "recorded device")
        self.n_devices = n_devices
        self._wp = []
        for i in range(n_devices):
            wp = sorted((float(t), float(x), float(y))
                        for t, x, y in waypoints[i % len(waypoints)])
            self._wp.append(wp)

    def position(self, i: int, t: float) -> np.ndarray:
        wp = self._wp[i]
        if t <= wp[0][0]:
            return np.array(wp[0][1:])
        for (t0, x0, y0), (t1, x1, y1) in zip(wp, wp[1:]):
            if t0 <= t <= t1:
                frac = 0.0 if t1 <= t0 else (t - t0) / (t1 - t0)
                return np.array([x0 + frac * (x1 - x0),
                                 y0 + frac * (y1 - y0)])
        return np.array(wp[-1][1:])


def make_motion(cfg: MobilityConfig, n_devices: int,
                area_radius_m: float) -> Optional[MotionModel]:
    """Build the configured motion model; ``static`` -> None (the fleet
    keeps the paper's per-round re-drop path untouched)."""
    if cfg.kind == "static":
        return None
    area = cfg.area_radius_m if cfg.area_radius_m is not None \
        else area_radius_m
    if cfg.kind == "random_waypoint":
        return RandomWaypoint(n_devices, area, cfg)
    if cfg.kind == "gauss_markov":
        return GaussMarkov(n_devices, area, cfg)
    from repro_torch.mobility.scenario import ScenarioTrace
    return ScenarioTrace.load(cfg.scenario_file).mobility(n_devices)
