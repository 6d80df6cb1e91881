"""Unified JSON scenario traces: positions + availability + backhaul.

One file describes a whole replayable world — where every device is over
time, when it is reachable, and what each cell's edge->cloud link offers
— so a measured deployment (or a synthesized stress scenario) drives the
simulator end to end from a single artifact.

Schema (all sections optional; times in simulated seconds)::

    {
      "devices": [
        {"waypoints": [[t, x, y], ...],       # piecewise-linear motion
         "on": [[start, end], ...]},          # availability intervals
        ...
      ],
      "cells": [
        {"site": [x, y],                      # fixed site coordinates
         "backhaul_bps": [[t, rate], ...]},   # step-wise rate over time
        ...
      ]
    }

The three sections feed three existing consumers:

* ``mobility(n)``      -> :class:`repro_torch.mobility.motion.ReplayMobility`
  (device positions; cycled over the fleet when the trace is smaller);
* ``availability(n)``  -> the *existing*
  :class:`repro_torch.fleet.ReplayTrace` — ``fleet.ReplayTrace.from_file``
  also accepts this schema directly, so ``--availability replay
  --trace-file scenario.json`` composes with ``--mobility replay
  --scenario-trace scenario.json`` without a second file;
* ``sites()`` / ``backhaul_rate(k, t)`` -> per-cell geometry and the
  heterogeneous, *time-varying* backhaul draw the runner folds into
  each round's shipping cost.

A bare ``{"devices": [[[s, e], ...], ...]}`` availability file (the
pre-scenario format) still loads; missing sections simply return None.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional

import numpy as np

from repro_torch.mobility.motion import ReplayMobility


@dataclasses.dataclass
class ScenarioTrace:
    """Parsed scenario file; build with :meth:`load` or field-by-field."""
    devices: list                    # per-device dicts (waypoints / on)
    cells: list                      # per-cell dicts (site / backhaul_bps)

    @classmethod
    def load(cls, path: str) -> "ScenarioTrace":
        raw = json.load(open(path))
        if isinstance(raw, list):
            # bare per-device interval lists: availability-only legacy
            raw = {"devices": [{"on": iv} for iv in raw]}
        devices = []
        for d in raw.get("devices", []):
            devices.append({"on": d.get("on")} if isinstance(d, dict)
                           else {"on": d})
            if isinstance(d, dict) and "waypoints" in d:
                devices[-1]["waypoints"] = d["waypoints"]
        return cls(devices=devices, cells=list(raw.get("cells", [])))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"devices": self.devices, "cells": self.cells}, f)

    # ------------------------------------------------------------ sections

    @property
    def has_mobility(self) -> bool:
        return any("waypoints" in d for d in self.devices)

    @property
    def has_availability(self) -> bool:
        return any(d.get("on") is not None for d in self.devices)

    @property
    def has_backhaul(self) -> bool:
        return any(c.get("backhaul_bps") for c in self.cells)

    def mobility(self, n_devices: int) -> ReplayMobility:
        wps = [d["waypoints"] for d in self.devices if "waypoints" in d]
        if not wps:
            raise ValueError("scenario trace has no device waypoints")
        return ReplayMobility(wps, n_devices)

    def availability_intervals(self) -> list[list[tuple[float, float]]]:
        """Per-device on-intervals in the shape ``fleet.ReplayTrace``
        consumes; a device with no ``on`` section is always-on."""
        out = []
        for d in self.devices:
            iv = d.get("on")
            out.append([(0.0, math.inf)] if iv is None
                       else [(float(s), float(e)) for s, e in iv])
        return out

    def availability(self, n_devices: int):
        from repro_torch.fleet import ReplayTrace
        return ReplayTrace(self.availability_intervals(), n_devices)

    def sites(self) -> Optional[np.ndarray]:
        if not self.cells or any("site" not in c for c in self.cells):
            return None
        return np.asarray([c["site"] for c in self.cells], np.float64)

    def backhaul_rate(self, cell: int, t: float) -> Optional[float]:
        """Step-wise provisioned rate of ``cell`` at time ``t`` (the last
        sample at or before ``t``; the first sample before any).  None
        when the trace carries no rate series for the cell."""
        if cell >= len(self.cells):
            return None
        series = self.cells[cell].get("backhaul_bps")
        if not series:
            return None
        # tolerate hand-edited / log-merged files: order by sample time
        # (the sibling waypoint and interval loaders sort too)
        series = sorted((float(ts), float(r)) for ts, r in series)
        rate = series[0][1]
        for ts, r in series:
            if ts <= t:
                rate = r
            else:
                break
        return rate
