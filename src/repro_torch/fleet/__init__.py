"""Fleet dynamics and client selection: the control plane that makes the
simulated fleet an on-demand one.

``availability``  seeded on/off traces (always-on, 2-state Markov,
                  diurnal sinusoid, JSON replay); devices join and leave
                  the cell over simulated time and can churn mid-round.
``battery``       per-device state of charge: dispatches debit the
                  realized ``E_cmp + E_com``, a trickle recharges, and the
                  headroom above reserve clamps the ``E_max`` the
                  Problem-(P4) solver sees.
``selection``     uniform / energy-headroom-weighted / gain-aware
                  (Definition 3) / Oort-style sampling behind one
                  interface, with per-round participation caps and a
                  selection generator of its own.
``dynamics``      the bundle config a ``FleetConfig`` carries.

Numpy only, and the same generators, seeds and draws as
``repro/fleet/``, so one seed gives the reference's traces, batteries
and cohorts.  The all-default config is the static fleet bit for bit: it
consumes no randomness and schedules no event.
"""
from repro_torch.fleet.availability import (AlwaysOn, AvailabilityConfig,
                                            AvailabilityTrace, DiurnalTrace,
                                            MarkovTrace, ReplayTrace,
                                            make_trace)
from repro_torch.fleet.battery import BatteryConfig, BatteryState
from repro_torch.fleet.dynamics import FleetDynamicsConfig
from repro_torch.fleet.selection import (SELECTIONS, EnergyHeadroomSelection,
                                         GainAwareSelection, OortSelection,
                                         SelectionPolicy, UniformSelection,
                                         make_selection)

__all__ = [
    "AlwaysOn", "AvailabilityConfig", "AvailabilityTrace", "DiurnalTrace",
    "MarkovTrace", "ReplayTrace", "make_trace",
    "BatteryConfig", "BatteryState",
    "FleetDynamicsConfig",
    "SELECTIONS", "SelectionPolicy", "UniformSelection",
    "EnergyHeadroomSelection", "GainAwareSelection", "OortSelection",
    "make_selection",
]
