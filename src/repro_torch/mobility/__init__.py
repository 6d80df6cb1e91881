"""Mobility: moving devices over a cellular world.

``motion``    seeded motion models (``static``, which builds nothing;
              ``random_waypoint`` with an optional hotspot bias;
              ``gauss_markov`` AR(1) velocities; ``replay`` from a
              recorded trace) evolving per-device 2-D positions in
              continuous simulated time; Eq. 8 sees the true distance to
              the serving cell site.
``handover``  round-boundary re-assignment of devices to cells:
              ``nearest`` with a hysteresis margin, or ``load_balanced``
              across near-tie sites, with one HANDOVER event per move;
              updates in flight merge at the cell that dispatched them.
``scenario``  one JSON trace of positions, availability and per-cell
              time-varying backhaul rates.

Numpy only, and the same generators, seeds and draws as
``repro/mobility/``, so one seed gives the reference's trajectories and
handovers.  ``MobilityConfig(kind="static")`` attaches no motion model
and consumes no randomness.
"""
from repro_torch.mobility.handover import (HANDOVER_POLICIES, HandoverConfig,
                                           HandoverEngine, assign_nearest)
from repro_torch.mobility.motion import (KINDS, GaussMarkov, MobilityConfig,
                                         MotionModel, RandomWaypoint,
                                         ReplayMobility, make_motion)
from repro_torch.mobility.scenario import ScenarioTrace

__all__ = [
    "KINDS", "MobilityConfig", "MotionModel", "RandomWaypoint",
    "GaussMarkov", "ReplayMobility", "make_motion",
    "HANDOVER_POLICIES", "HandoverConfig", "HandoverEngine",
    "assign_nearest", "ScenarioTrace",
]
