"""Heterogeneous device fleet sampler (paper §V-A.2), flat or split into
cells, static or dynamic, fixed or moving.

I = 60 devices in a 550 m cell; energy coefficient eps_i ~ U[5e-27, 1e-26];
positions re-dropped every round; per-round energy budget E_max ~ U[3, 9] J;
shared latency budget T_max.  A hierarchical topology
(``FleetConfig.topology``) binds each device to a cell with its own
wireless config.  ``FleetConfig.dynamics`` attaches an availability
trace and a battery (``repro_torch/fleet``); ``FleetConfig.mobility`` a
motion model, whose true distance to the serving site replaces the
per-round re-drop (``repro_torch/mobility``).  ``make_fleet``,
``Fleet.round_envs`` and ``Fleet.device_env`` consume the numpy
generator exactly as ``repro/sysmodel/population.py`` does, so one seed
gives the same envs; the traces, batteries and motion models draw from
generators of their own.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.schedule import DeviceEnv
from repro_torch.fleet import (AvailabilityTrace, BatteryState,
                               FleetDynamicsConfig, make_trace)
from repro_torch.mobility import (MobilityConfig, MotionModel, ScenarioTrace,
                                  assign_nearest, make_motion)
from repro_torch.sysmodel.wireless import (WirelessConfig, achievable_rate,
                                           drop_positions)
from repro_torch.topology.cells import (TopologyConfig, assign_cells,
                                        cell_sites)

#: vgg9-cifar's fleet budgets (``FleetConfig(**VGG9_BUDGETS)``): T_max and
#: E_max scaled about as its work a sample is (12.6 times fmnist-cnn's);
#: on the default budgets no device finds a feasible AnycostFL strategy
VGG9_BUDGETS = dict(T_max=120.0, E_max_range=(30.0, 90.0))


@dataclasses.dataclass
class FleetConfig:
    n_devices: int = 60
    T_max: float = 10.0
    E_max_range: tuple = (3.0, 9.0)
    eps_range: tuple = (5e-27, 1e-26)
    f_min: float = 0.3e9
    f_max: float = 2.0e9
    tau: float = 1.0
    alpha_min: float = 0.25
    beta_min: float = 1e-3
    beta_max: float = 1.0 / 15.0
    wireless: WirelessConfig = dataclasses.field(default_factory=WirelessConfig)
    # heterogeneity knobs for Fig. 5b-c: fix means, scale variances
    eps_var_scale: float = 1.0
    dist_mean_m: Optional[float] = None      # None -> uniform in cell
    dist_var_scale: float = 1.0
    # fleet dynamics control plane (None -> static always-on roster)
    dynamics: Optional[FleetDynamicsConfig] = None
    # multi-cell topology (None / flat -> the paper's single cell)
    topology: Optional[TopologyConfig] = None
    # device motion (None / "static" -> the paper's per-round re-drop)
    mobility: Optional[MobilityConfig] = None


@dataclasses.dataclass
class Fleet:
    cfg: FleetConfig
    eps_hw: np.ndarray        # (I,) fixed per device
    E_max: np.ndarray         # (I,) fixed per device
    data_sizes: np.ndarray    # (I,) samples per device
    # dynamics state (seeded apart from the sampling stream)
    trace: Optional[AvailabilityTrace] = None
    battery: Optional[BatteryState] = None
    # hierarchical topology: device -> cell id and per-cell wireless
    # (None -> the single macro cell)
    cells: Optional[np.ndarray] = None
    cell_wireless: Optional[list] = None
    # mobility: motion model and fixed cell-site coordinates (None -> a
    # static fleet, positions re-dropped every round)
    mobility: Optional[MotionModel] = None
    sites: Optional[np.ndarray] = None     # (C, 2)
    # the parsed scenario behind a replay motion model (the runner's
    # time-varying backhaul reads it)
    scenario: Optional[ScenarioTrace] = None

    @property
    def n_cells(self) -> int:
        return len(self.cell_wireless) if self.cell_wireless else 1

    def cell_of(self, i: int) -> int:
        return int(self.cells[i]) if self.cells is not None else 0

    def _wireless(self, i: int) -> WirelessConfig:
        if self.cell_wireless is None:
            return self.cfg.wireless
        return self.cell_wireless[self.cell_of(i)]

    def _env(self, i: int, rate: float, W: float, S_bits: float) -> DeviceEnv:
        c = self.cfg
        return DeviceEnv(
            T_max=c.T_max, E_max=float(self.E_max[i]),
            P_com=self._wireless(i).tx_power_w, rate=float(rate),
            W=W, D=int(self.data_sizes[i]), tau=c.tau,
            eps_hw=float(self.eps_hw[i]), S_bits=S_bits,
            f_min=c.f_min, f_max=c.f_max, alpha_min=c.alpha_min,
            beta_min=c.beta_min, beta_max=c.beta_max)

    def _distances(self, rng: np.random.Generator, n: int,
                   w: WirelessConfig) -> np.ndarray:
        c = self.cfg
        if c.dist_mean_m is None:
            pos = drop_positions(rng, n, w)
            return np.linalg.norm(pos, axis=-1)
        spread = (w.cell_radius_m / 4.0) * np.sqrt(c.dist_var_scale)
        return np.clip(rng.normal(c.dist_mean_m, spread, n),
                       10.0, w.cell_radius_m)

    # ---------------------------------------------------------- mobility

    def positions(self, t: float) -> np.ndarray:
        """(I, 2) fleet positions at simulated time ``t`` (mobile only)."""
        assert self.mobility is not None, "static fleet has no positions"
        return self.mobility.positions_at(t)

    def serving_distances(self, t: float) -> np.ndarray:
        """(I,) distance of every device to its *serving* cell site at
        time ``t``: what Eq. 8 sees under mobility."""
        pos = self.positions(t)
        sites = self.sites if self.sites is not None else np.zeros((1, 2))
        cells = self.cells if self.cells is not None \
            else np.zeros(self.cfg.n_devices, np.int64)
        return np.linalg.norm(pos - sites[cells], axis=-1)

    def _mobile_envs(self, rng: np.random.Generator, W: float,
                     S_bits: float, t: float) -> list[DeviceEnv]:
        """Envs from true motion: the distances are geometry, and only
        the Rayleigh fading draws consume the rng (per cell, ascending,
        the stream shape of the static hierarchical path)."""
        c = self.cfg
        dist = self.serving_distances(t)
        rates = np.empty(c.n_devices)
        if self.cells is None or self.n_cells == 1:
            w = self.cell_wireless[0] if self.cell_wireless else c.wireless
            rates[:] = achievable_rate(dist, w, rng=rng)
        else:
            for k in range(self.n_cells):
                idx = np.flatnonzero(self.cells == k)
                if len(idx):
                    rates[idx] = achievable_rate(
                        dist[idx], self.cell_wireless[k], rng=rng)
        return [self._env(i, rates[i], W, S_bits)
                for i in range(c.n_devices)]

    # ------------------------------------------------------------- envs

    def round_envs(self, rng: np.random.Generator, W: float,
                   S_bits: float, t: float = 0.0) -> list[DeviceEnv]:
        """Re-drop positions, draw fading and build per-device envs
        (Eq. 6-9).

        A multi-cell fleet draws each cell's positions and fading against
        that cell's wireless config, in ascending cell order.  A 1-cell
        hierarchy takes the flat draw with the same config object, so it
        consumes the same stream and gives the same envs.  With a motion
        model the positions are not re-dropped: the distances come from
        the trajectories at time ``t`` and only the fading draws consume
        the rng."""
        c = self.cfg
        if self.mobility is not None:
            return self._mobile_envs(rng, W, S_bits, t)
        if self.cells is None or self.n_cells == 1:
            w = self.cell_wireless[0] if self.cell_wireless else c.wireless
            dist = self._distances(rng, c.n_devices, w)
            rates = achievable_rate(dist, w, rng=rng)
        else:
            rates = np.empty(c.n_devices)
            for k in range(self.n_cells):
                idx = np.flatnonzero(self.cells == k)
                w = self.cell_wireless[k]
                dist = self._distances(rng, len(idx), w)
                rates[idx] = achievable_rate(dist, w, rng=rng)
        return [self._env(i, rates[i], W, S_bits)
                for i in range(c.n_devices)]

    def device_env(self, rng: np.random.Generator, i: int, W: float,
                   S_bits: float, t: float = 0.0) -> DeviceEnv:
        """A fresh channel draw for device i alone (fedbuff's
        re-dispatch): a static fleet re-drops its position in its cell,
        one device's share of :meth:`round_envs`' stream; a mobile one
        reads its true position at the dispatch time ``t`` and draws only
        the fading."""
        w = self._wireless(i)
        if self.mobility is not None:
            site = self.sites[self.cell_of(i)] if self.sites is not None \
                else np.zeros(2)
            dist = np.asarray([np.linalg.norm(
                self.mobility.position(i, t) - site)])
        else:
            dist = self._distances(rng, 1, w)
        rate = achievable_rate(dist, w, rng=rng)
        return self._env(i, rate[0], W, S_bits)

    # -------------------------------------------------------- fleet dynamics

    def available(self, i: int, t: float) -> bool:
        """Is device i dispatchable at time t (in the cell and charged)?"""
        if self.trace is not None and not self.trace.available(i, t):
            return False
        if self.battery is not None and not self.battery.available(i, t):
            return False
        return True

    def next_departure(self, i: int, t: float) -> float:
        """When a device now present next leaves the cell (inf: never)."""
        return self.trace.next_change(i, t) if self.trace is not None \
            else math.inf

    def dynamic_env(self, i: int, env: DeviceEnv, t: float) -> DeviceEnv:
        """Clamp the round's energy budget by the battery headroom, so
        the Problem-(P4) solver plans with what the device can spend now;
        the env itself when no battery is attached."""
        if self.battery is None:
            return env
        return dataclasses.replace(
            env, E_max=min(env.E_max, self.battery.headroom(i, t)))

    def debit(self, i: int, energy_j: float, t: float) -> None:
        if self.battery is not None:
            self.battery.debit(i, energy_j, t)


def make_fleet(rng: np.random.Generator, cfg: FleetConfig,
               data_sizes: np.ndarray) -> Fleet:
    lo, hi = cfg.eps_range
    mean = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo) * np.sqrt(cfg.eps_var_scale)
    eps = rng.uniform(mean - half, mean + half, cfg.n_devices)
    eps = np.clip(eps, 1e-28, None)
    e_lo, e_hi = cfg.E_max_range
    e_max = rng.uniform(e_lo, e_hi, cfg.n_devices)
    if len(data_sizes) != cfg.n_devices:
        raise ValueError(f"{len(data_sizes)} data sizes for "
                         f"{cfg.n_devices} devices")
    trace = battery = None
    if cfg.dynamics is not None:
        # the dynamics draw from generators of their own, never from the
        # sampling rng: the eps/E_max/position streams stay as they are
        trace = make_trace(cfg.dynamics.availability, cfg.n_devices)
        if cfg.dynamics.battery is not None:
            battery = BatteryState(cfg.dynamics.battery, cfg.n_devices)
    # the motion model is seeded apart too; "static" builds nothing
    mobility = sites = scenario = None
    if cfg.mobility is not None and cfg.mobility.kind != "static":
        if cfg.mobility.kind == "replay":
            scenario = ScenarioTrace.load(cfg.mobility.scenario_file)
            mobility = scenario.mobility(cfg.n_devices)
            sites = scenario.sites()
        else:
            mobility = make_motion(cfg.mobility, cfg.n_devices,
                                   cfg.wireless.cell_radius_m)
    cells = cell_wireless = None
    if cfg.topology is not None and cfg.topology.kind == "hier":
        cell_wireless = cfg.topology.cell_wireless(cfg.wireless)
        if sites is not None and len(sites) != cfg.topology.n_cells:
            # regenerated ring sites would measure every replayed
            # trajectory against geometry the trace never described
            raise ValueError(
                f"scenario trace describes {len(sites)} cell sites but "
                f"the topology asks for {cfg.topology.n_cells} cells; "
                f"match n_cells to the trace (or drop its 'site' "
                f"entries to use the generated ring geometry)")
        if sites is None:
            sites = cell_sites(cfg.topology.n_cells,
                               cfg.wireless.cell_radius_m)
        if mobility is not None:
            # every device starts in the cell whose site is nearest at
            # t = 0 (the motion model is seeded, so this is deterministic)
            cells = assign_nearest(mobility.positions_at(0.0), sites)
        else:
            # deterministic assignment, no rng: the eps/E_max/position
            # streams are the same with or without a topology
            cells = assign_cells(cfg.n_devices, cfg.topology)
    elif mobility is not None and sites is None:
        sites = np.zeros((1, 2))     # flat: the macro site at the origin
    return Fleet(cfg, eps, e_max, np.asarray(data_sizes),
                 trace=trace, battery=battery,
                 cells=cells, cell_wireless=cell_wireless,
                 mobility=mobility, sites=sites, scenario=scenario)
