"""Client-selection policies (fleet dynamics, control plane).

At every round start the orchestrator hands the policy the *available*
device ids (availability trace on, battery above reserve), their
dynamic-budget :class:`~repro_torch.core.schedule.DeviceEnv` draws, a
per-device energy-headroom map, and the participation cap; the policy
returns the ids to dispatch, in ascending order (the runner's per-device
RNG draws follow device order, so a stable ordering keeps seeded runs
replayable).

* ``uniform`` — the paper's implicit behaviour: everyone participates;
  under a cap, a uniform sample without replacement.  When the cap does
  not bind this consumes **no** randomness and returns the candidate list
  unchanged, which keeps static-fleet runs bit-identical to the
  loop with no control plane.
* ``energy``  — sample proportional to energy headroom (battery joules
  above reserve when a battery model is attached, otherwise the static
  ``E_max`` draw), so nearly-drained devices are rarely asked to spend
  their reserve ("to talk or to work" style energy feedback).
* ``gain``    — deterministic top-k by the expected local learning gain
  ``g = alpha^4 * beta`` (Definition 3) of each device's *solved*
  Problem-(P4) strategy under its current channel/budget draw: the
  control plane ranks devices by how much useful training their budgets
  buy this round.
* ``oort``    — Oort-style utility = solved gain x speed, where speed is
  the deadline fraction the device's planned round leaves unused,
  ``min(1, T_max / (T_cmp + T_com))^speed_exp`` — plus an exploration
  reserve: a fraction of each round's cap is spent on devices the policy
  has selected least often (ties broken uniformly at random), so a
  momentarily-faded fast device is still probed over time.

Selection randomness comes from a dedicated generator (see
``--selection-seed``) so who-trains-when ablations never perturb the
model-init / data / channel streams.
"""
from __future__ import annotations

import collections
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core import schedule

SELECTIONS = ("uniform", "energy", "gain", "oort")


class SelectionPolicy:
    """Interface: pick <= cap device ids out of the available candidates."""

    name = "base"

    def select(self, candidates: Sequence[int],
               envs: Mapping[int, schedule.DeviceEnv],
               headroom: Mapping[int, float], cap: int) -> list[int]:
        raise NotImplementedError


class UniformSelection(SelectionPolicy):
    name = "uniform"

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def select(self, candidates, envs, headroom, cap):
        if cap >= len(candidates):
            return list(candidates)     # no draw: the static fleet
        pick = self.rng.choice(len(candidates), size=cap, replace=False)
        return sorted(candidates[j] for j in pick)


class EnergyHeadroomSelection(SelectionPolicy):
    name = "energy"

    def __init__(self, rng: np.random.Generator):
        self.rng = rng

    def select(self, candidates, envs, headroom, cap):
        if cap >= len(candidates):
            return list(candidates)
        w = np.array([max(headroom[i], 0.0) for i in candidates])
        # strictly positive floor: choice(replace=False) needs >= cap
        # non-zero probabilities even when few devices have headroom
        w = w + 1e-9 * max(float(w.max()), 1.0)
        pick = self.rng.choice(len(candidates), size=cap, replace=False,
                               p=w / w.sum())
        return sorted(candidates[j] for j in pick)


class GainAwareSelection(SelectionPolicy):
    name = "gain"

    def __init__(self, rng: np.random.Generator):
        del rng     # deterministic rank; kept for a uniform constructor

    def select(self, candidates, envs, headroom, cap):
        if cap >= len(candidates):
            return list(candidates)
        # rank by expected gain of the solved strategy; ties -> device id.
        # prepare() re-solves for the selected devices — the closed-form
        # solve costs microseconds, and recomputing keeps the selection
        # layer stateless and the runner's rng/key stream untouched
        ranked = sorted(candidates,
                        key=lambda i: (-schedule.solve(envs[i]).gain, i))
        return sorted(ranked[:cap])


class OortSelection(SelectionPolicy):
    """Utility = solved gain x speed, with a least-selected exploration
    reserve (Lai et al., *Oort: Efficient Federated Learning via Guided
    Participant Selection*, adapted to AnycostFL's Definition-3 gain).

    Exploitation ranks candidates by how much useful training their
    budgets buy this round *and* how quickly they return it; exploration
    keeps probing under-sampled devices whose current channel draw looks
    bad, so the policy never locks onto an early cohort.  Stateful across
    rounds (selection counts), seeded by the dedicated selection rng.
    """

    name = "oort"

    def __init__(self, rng: np.random.Generator, *,
                 explore_frac: float = 0.2, speed_exp: float = 1.0):
        self.rng = rng
        self.explore_frac = explore_frac
        self.speed_exp = speed_exp
        self.n_selected: collections.Counter = collections.Counter()

    def utility(self, env: schedule.DeviceEnv) -> float:
        s = schedule.solve(env)
        t = max(s.T_cmp + s.T_com, 1e-9)
        speed = min(1.0, env.T_max / t) ** self.speed_exp
        return s.gain * speed

    def select(self, candidates, envs, headroom, cap):
        if cap >= len(candidates):
            picked = list(candidates)     # no draw: the static fleet
        else:
            n_explore = min(int(round(self.explore_frac * cap)), cap)
            # exploration reserve: least-selected first, uniform-random
            # within a count tie (the only randomness this policy uses)
            order = self.rng.permutation(len(candidates))
            by_count = sorted((self.n_selected[candidates[j]], k)
                              for k, j in enumerate(order))
            explore = [candidates[order[k]]
                       for _, k in by_count[:n_explore]]
            taken = set(explore)
            ranked = sorted((i for i in candidates if i not in taken),
                            key=lambda i: (-self.utility(envs[i]), i))
            picked = explore + ranked[:cap - len(explore)]
        for i in picked:
            self.n_selected[i] += 1
        return sorted(picked)


def make_selection(name: str, rng: np.random.Generator) -> SelectionPolicy:
    if name == "uniform":
        return UniformSelection(rng)
    if name == "energy":
        return EnergyHeadroomSelection(rng)
    if name == "gain":
        return GainAwareSelection(rng)
    if name == "oort":
        return OortSelection(rng)
    raise ValueError(f"unknown selection policy {name!r}; "
                     f"expected one of {SELECTIONS}")
