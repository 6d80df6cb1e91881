"""Per-round cell handover: dynamic device->cell re-assignment.

With a motion model attached, a device's serving cell is no longer a
static function of its id — at every round boundary the handover engine
re-evaluates the device->cell binding from the fleet's *current*
positions and the fixed cell-site coordinates:

* ``none``          — no re-assignment ever (the stale-cell baseline: a
  device keeps the cell it started in however far it wanders).
* ``nearest``       — switch to the closest site, but only when it beats
  the serving site by more than ``margin_m`` metres (hysteresis — the
  cellular A3 offset — so a device oscillating around the midpoint
  between two sites never ping-pongs).
* ``load_balanced`` — among the sites within ``margin_m`` of the
  nearest (the candidate set), pick the least-loaded one; a device only
  leaves its serving cell when the move strictly shrinks the occupancy
  gap (or when the serving site fell out of the candidate set), which
  both spreads skewed spatial load across cells and keeps assignments
  hysteretic.

Re-assignment is deterministic: devices are visited in ascending id with
loads updated incrementally, so seeded runs replay the identical
handover sequence.  The orchestrator emits one HANDOVER event per move
and logs per-round counts on ``RoundLog`` (see
``orchestrator/runner.py``); updates already in flight keep the cell
that dispatched them (``PendingUpdate.cell``), so an edge partial is
always folded at the edge that actually served the uplink.
"""
from __future__ import annotations

import dataclasses

import numpy as np

HANDOVER_POLICIES = ("none", "nearest", "load_balanced")


@dataclasses.dataclass(frozen=True)
class HandoverConfig:
    policy: str = "nearest"
    # hysteresis margin in metres: nearest -> required improvement before
    # switching; load_balanced -> width of the near-tie candidate set
    margin_m: float = 25.0

    def __post_init__(self):
        if self.policy not in HANDOVER_POLICIES:
            raise ValueError(f"unknown handover policy {self.policy!r}; "
                             f"expected one of {HANDOVER_POLICIES}")
        if self.margin_m < 0:
            raise ValueError("handover margin_m must be >= 0")


def assign_nearest(positions: np.ndarray, sites: np.ndarray) -> np.ndarray:
    """(I,) cell ids: each device homed to its closest site (ties ->
    lowest id).  The initial binding of a mobile fleet."""
    d = np.linalg.norm(positions[:, None, :] - sites[None, :, :], axis=-1)
    return np.argmin(d, axis=1).astype(np.int64)


class HandoverEngine:
    """Round-boundary re-assignment under one of the policies above."""

    def __init__(self, cfg: HandoverConfig, sites: np.ndarray):
        self.cfg = cfg
        self.sites = np.asarray(sites, np.float64)

    def reassign(self, positions: np.ndarray, cells: np.ndarray
                 ) -> tuple[np.ndarray, list[tuple[int, int, int]]]:
        """New (I,) cell ids plus the moves ``[(device, old, new), ...]``.

        ``cells`` is left untouched; determinism comes from visiting
        devices in ascending id and updating the load vector after every
        accepted move.
        """
        cells = np.asarray(cells)
        if self.cfg.policy == "none":
            return cells.copy(), []
        d = np.linalg.norm(positions[:, None, :] - self.sites[None, :, :],
                           axis=-1)                      # (I, C)
        new = cells.copy()
        loads = np.bincount(cells, minlength=len(self.sites)).astype(int)
        moves: list[tuple[int, int, int]] = []
        margin = self.cfg.margin_m
        for i in range(len(cells)):
            cur = int(cells[i])
            nearest = int(np.argmin(d[i]))
            if self.cfg.policy == "nearest":
                target = nearest if d[i, nearest] < d[i, cur] - margin \
                    else cur
            else:
                cand = np.flatnonzero(d[i] <= d[i, nearest] + margin)
                # least-loaded candidate, distance then id as tiebreaks
                target = int(min(cand, key=lambda k: (loads[k], d[i, k], k)))
                if cur in cand and loads[target] + 1 >= loads[cur]:
                    # moving would not strictly shrink the occupancy gap:
                    # stay hysteretic (no ping-pong between near-ties)
                    target = cur
            if target != cur:
                loads[cur] -= 1
                loads[target] += 1
                new[i] = target
                moves.append((i, cur, target))
        return new, moves
