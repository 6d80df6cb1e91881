"""Top-level fleet-dynamics configuration.

One dataclass bundles the three control-plane levers — availability
trace, battery model, selection policy — so callers attach dynamics to a
:class:`~repro_torch.sysmodel.population.FleetConfig` with a single field.  The
all-default config (``always`` availability, no battery, ``uniform``
selection, no participation cap) is exactly the static fleet: it consumes
no extra randomness and schedules no extra events, so runs with it are
bit-identical to runs with no dynamics attached.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.fleet.availability import AvailabilityConfig
from repro_torch.fleet.battery import BatteryConfig
from repro_torch.fleet.selection import SELECTIONS


@dataclasses.dataclass
class FleetDynamicsConfig:
    availability: AvailabilityConfig = dataclasses.field(
        default_factory=AvailabilityConfig)
    battery: Optional[BatteryConfig] = None
    selection: str = "uniform"
    # per-round participation cap as a fraction of the *available* devices
    participation: float = 1.0
    # independent stream for who-trains-when; None -> derived from the run
    # seed through a decorrelated generator (see Simulation)
    selection_seed: Optional[int] = None
    # battery-aware deadline adaptation: when the fleet's mean state of
    # charge drops below the threshold, the effective T_max handed to the
    # Problem-(P4) solver shrinks by this factor (None -> never; the
    # static-fleet no-op default)
    soc_deadline_scale: Optional[float] = None
    soc_deadline_threshold: float = 0.5

    def __post_init__(self):
        if self.selection not in SELECTIONS:
            raise ValueError(f"unknown selection {self.selection!r}; "
                             f"expected one of {SELECTIONS}")
        if not 0.0 < self.participation <= 1.0:
            raise ValueError("participation must be in (0, 1]")
        if self.soc_deadline_scale is not None \
                and not 0.0 < self.soc_deadline_scale <= 1.0:
            raise ValueError("soc_deadline_scale must be in (0, 1]")
        if not 0.0 <= self.soc_deadline_threshold <= 1.0:
            raise ValueError("soc_deadline_threshold must be in [0, 1]")
