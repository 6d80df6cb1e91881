"""Multi-cell topology: device->cell assignment and per-cell wireless.

A hierarchical deployment partitions the fleet across ``n_cells`` edge
cells, each with its own wireless environment: its base station serves a
smaller area, so uplink distances, and with them the Eq. 8 rates,
improve as the macro cell is split.  The default per-cell radius scale
is ``1/sqrt(n_cells)`` (the cells tile the macro cell's area), so one
cell keeps the paper's 550 m geometry exactly.

Assignment is deterministic and consumes no randomness: ``contiguous``
gives each cell a block of device ids, ``round_robin`` stripes them.
With a motion model attached the binding becomes geometric and changes
between rounds: devices start in their nearest cell
(``mobility.assign_nearest`` over the fixed :func:`cell_sites`) and the
handover engine re-homes them at round boundaries
(``TopologyConfig.handover``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.mobility.handover import HandoverConfig
from repro_torch.sysmodel.wireless import WirelessConfig
from repro_torch.topology.backhaul import BackhaulConfig, sample_cell_backhauls

TOPOLOGIES = ("flat", "hier")
ASSIGNMENTS = ("contiguous", "round_robin")


def cell_sites(n_cells: int, macro_radius_m: float) -> np.ndarray:
    """(C, 2) fixed site coordinates inside the macro cell: one cell at
    the macro centre; C > 1 cells evenly on a ring at half the macro
    radius."""
    if n_cells == 1:
        return np.zeros((1, 2))
    ang = 2.0 * math.pi * np.arange(n_cells) / n_cells
    ring = macro_radius_m / 2.0
    return np.stack([ring * np.cos(ang), ring * np.sin(ang)], -1)


@dataclasses.dataclass
class TopologyConfig:
    kind: str = "flat"
    n_cells: int = 1
    assignment: str = "contiguous"
    # per-cell multiplier on the base cell radius; None -> 1/sqrt(n_cells)
    cell_radius_scale: Optional[float] = None
    backhaul: BackhaulConfig = dataclasses.field(
        default_factory=BackhaulConfig)
    # per-cell edge deadline; None -> the arrival policy's own barrier
    # applies within each cell
    cell_deadline_s: Optional[float] = None
    # round-boundary device->cell re-assignment (mobile fleets only);
    # None -> the binding never changes
    handover: Optional[HandoverConfig] = None
    # heterogeneous backhaul: seeded per-cell rate draw (log-uniform over
    # the range); None -> every cell gets `backhaul` verbatim
    backhaul_rate_range: Optional[tuple] = None
    backhaul_het_seed: int = 0

    def __post_init__(self):
        if self.kind not in TOPOLOGIES:
            raise ValueError(f"unknown topology {self.kind!r}; "
                             f"expected one of {TOPOLOGIES}")
        if self.assignment not in ASSIGNMENTS:
            raise ValueError(f"unknown assignment {self.assignment!r}; "
                             f"expected one of {ASSIGNMENTS}")
        if self.n_cells < 1:
            raise ValueError("n_cells must be >= 1")
        if self.kind == "flat" and self.n_cells != 1:
            raise ValueError("flat topology has exactly one cell")
        if self.backhaul_rate_range is not None:
            lo, hi = self.backhaul_rate_range
            if not 0 < lo <= hi:
                raise ValueError("backhaul_rate_range must satisfy "
                                 "0 < lo <= hi")

    @property
    def radius_scale(self) -> float:
        if self.cell_radius_scale is not None:
            return self.cell_radius_scale
        return 1.0 / math.sqrt(self.n_cells)

    def cell_wireless(self, base: WirelessConfig) -> list[WirelessConfig]:
        """Per-cell wireless configs derived from the macro-cell base."""
        scale = self.radius_scale
        if scale == 1.0:
            # the base object itself, so a 1-cell hierarchy consumes the
            # flat path's channel stream
            return [base] * self.n_cells
        return [dataclasses.replace(
            base, cell_radius_m=base.cell_radius_m * scale)
            for _ in range(self.n_cells)]

    def cell_backhauls(self) -> list[BackhaulConfig]:
        """One backhaul config per cell: the shared ``backhaul`` C times,
        or a seeded per-cell rate draw with ``backhaul_rate_range``."""
        if self.backhaul_rate_range is None:
            return [self.backhaul] * self.n_cells
        return sample_cell_backhauls(self.backhaul, self.n_cells,
                                     self.backhaul_rate_range,
                                     seed=self.backhaul_het_seed)


def assign_cells(n_devices: int, topo: TopologyConfig) -> np.ndarray:
    """(I,) int array of cell ids; deterministic, every cell non-empty
    when n_devices >= n_cells."""
    if topo.n_cells > n_devices:
        raise ValueError(f"{topo.n_cells} cells need >= that many devices "
                         f"(got {n_devices})")
    ids = np.arange(n_devices)
    if topo.assignment == "round_robin":
        return ids % topo.n_cells
    # contiguous blocks, sizes as equal as possible
    return (ids * topo.n_cells) // n_devices
