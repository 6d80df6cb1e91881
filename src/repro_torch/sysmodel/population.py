"""Heterogeneous device fleet sampler (paper §V-A.2): static fleets, flat
or split into cells.

I = 60 devices in a 550 m cell; energy coefficient eps_i ~ U[5e-27, 1e-26];
positions re-dropped every round; per-round energy budget E_max ~ U[3, 9] J;
shared latency budget T_max.  A hierarchical topology
(``FleetConfig.topology``) binds each device to a cell with its own
wireless config.  ``make_fleet``, ``Fleet.round_envs`` and
``Fleet.device_env`` consume the numpy generator exactly as
``repro/sysmodel/population.py`` does for these fleets, so one seed
gives the same envs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.schedule import DeviceEnv
from repro_torch.sysmodel.wireless import (WirelessConfig, achievable_rate,
                                           drop_positions)
from repro_torch.topology.cells import TopologyConfig, assign_cells

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
    # multi-cell topology (None / flat -> the paper's single cell)
    topology: Optional[TopologyConfig] = None
    # fleet dynamics and device motion are not ported yet: anything but
    # None raises in make_fleet
    dynamics: Optional[Any] = None
    mobility: Optional[Any] = None


@dataclasses.dataclass
class Fleet:
    cfg: FleetConfig
    eps_hw: np.ndarray        # (I,) fixed per device
    E_max: np.ndarray         # (I,) fixed per device
    data_sizes: np.ndarray    # (I,) samples per device
    # hierarchical topology: device -> cell id and per-cell wireless
    # (None -> the single macro cell)
    cells: Optional[np.ndarray] = None
    cell_wireless: Optional[list] = None

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

    def round_envs(self, rng: np.random.Generator, W: float,
                   S_bits: float) -> list[DeviceEnv]:
        """Re-drop positions, draw fading and build per-device envs
        (Eq. 6-9).

        A multi-cell fleet draws each cell's positions and fading against
        that cell's wireless config, in ascending cell order.  A 1-cell
        hierarchy takes the flat draw with the same config object, so it
        consumes the same stream and gives the same envs."""
        c = self.cfg
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
                   S_bits: float) -> DeviceEnv:
        """A fresh channel draw for device i alone (fedbuff's
        re-dispatch): re-drop its position in its cell and draw its
        fading, one device's share of :meth:`round_envs`' stream."""
        w = self._wireless(i)
        rate = achievable_rate(self._distances(rng, 1, w), w, rng=rng)
        return self._env(i, rate[0], W, S_bits)


_NOT_PORTED = {
    "dynamics": "fleet dynamics (ROADMAP queue 1, 'Fleet dynamics')",
    "mobility": "mobility and handover (ROADMAP queue 1, 'Mobility')",
}


def make_fleet(rng: np.random.Generator, cfg: FleetConfig,
               data_sizes: np.ndarray) -> Fleet:
    for field, item in _NOT_PORTED.items():
        if getattr(cfg, field) is not None:
            raise NotImplementedError(
                f"FleetConfig.{field}: the port runs static fleets only; "
                f"{item} brings it")
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
    cells = cell_wireless = None
    if cfg.topology is not None and cfg.topology.kind == "hier":
        # deterministic assignment, no rng: the eps/E_max/position
        # streams are the same with or without a topology
        cell_wireless = cfg.topology.cell_wireless(cfg.wireless)
        cells = assign_cells(cfg.n_devices, cfg.topology)
    return Fleet(cfg, eps, e_max, np.asarray(data_sizes), cells=cells,
                 cell_wireless=cell_wireless)
