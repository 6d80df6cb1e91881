"""On-demand training strategy — the closed-form Problem-(P4) solver (§IV-D).

Per device i and round t, given
  T_max       shared round latency budget (server)
  E_max       device energy budget
  P_com       transmit power,  r  achievable uplink rate (Eq. 8)
  W           workload per sample (FLOPs),  D  local dataset size,  tau epochs
  eps_hw      hardware energy coefficient (Eq. 7)
  f in [f_min, f_max], alpha in [alpha_min, 1], beta in [beta_min, beta_max]

maximize the local learning gain g = alpha^4 * beta (Definition 3) subject
to Eq. 10a-10e. Lemma 3: both budgets bind at the optimum; reparameterize by
the latency split phi (Eq. 20-21); stationary points are the roots of a
quadratic (Eq. 24); evaluate g at the feasible stationary+boundary points
(Eq. 25) and recover (alpha*, beta*, f*) from Eq. 26.

Pure Python, float for float the reference's ``repro/core/schedule.py``.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class DeviceEnv:
    """Everything device i knows at the start of round t."""
    T_max: float            # s
    E_max: float            # J
    P_com: float            # W
    rate: float             # bit/s (Eq. 8)
    W: float                # FLOPs (cycles) per sample, full model
    D: int                  # |D_i| samples
    tau: float              # local epochs
    eps_hw: float           # J / (cycle/s)^2 / cycle  (Eq. 7 coefficient)
    S_bits: float           # uncompressed update size, bits
    f_min: float
    f_max: float
    alpha_min: float = 0.25
    beta_min: float = 1e-3
    beta_max: float = 1.0 / 15.0


@dataclasses.dataclass(frozen=True)
class Strategy:
    alpha: float
    beta: float
    freq: float
    phi: float               # latency split (Eq. 20)
    varphi: float            # energy split
    gain: float              # g = alpha^4 beta
    T_cmp: float
    T_com: float
    E_cmp: float
    E_com: float
    feasible: bool


def _recover(phi: float, env: DeviceEnv) -> Strategy:
    """Eq. 26 with projection onto the box constraints."""
    T, E, P = env.T_max, env.E_max, env.P_com
    work = env.tau * env.D * env.W
    varphi = 1.0 - (1.0 - phi) * T * P / E
    varphi = min(max(varphi, 0.0), 1.0)
    alpha = ((phi * T) ** 2 * varphi * E / (env.eps_hw * work ** 3)) ** (1.0 / 3.0) \
        if phi > 0 else env.alpha_min
    alpha = min(max(alpha, env.alpha_min), 1.0)
    beta = env.rate * (1.0 - phi) * T / (alpha * env.S_bits)
    beta = min(max(beta, env.beta_min), env.beta_max)
    freq = alpha * work / (phi * T) if phi > 0 else env.f_max
    freq = min(max(freq, env.f_min), env.f_max)
    # realized costs after projection
    T_cmp = alpha * work / freq
    E_cmp = env.eps_hw * freq ** 2 * alpha * work
    T_com = alpha * beta * env.S_bits / env.rate
    E_com = T_com * P
    feasible = (T_cmp + T_com <= T * (1 + 1e-6)) and \
        (E_cmp + E_com <= E * (1 + 1e-6))
    return Strategy(alpha=alpha, beta=beta, freq=freq, phi=phi,
                    varphi=varphi, gain=alpha ** 4 * beta,
                    T_cmp=T_cmp, T_com=T_com, E_cmp=E_cmp, E_com=E_com,
                    feasible=feasible)


def phi_bounds(env: DeviceEnv) -> tuple[float, float]:
    """Eq. 23."""
    T = env.T_max
    work = env.tau * env.D * env.W
    lo = max(env.alpha_min * work / (env.f_max * T),
             1.0 - env.beta_max * env.S_bits / (env.rate * T))
    hi = min(work / (env.f_min * T) if env.f_min > 0 else 1.0,
             1.0 - env.alpha_min * env.beta_min * env.S_bits
             / (env.rate * T))
    return max(lo, 1e-6), min(hi, 1.0 - 1e-6)


def stationary_points(env: DeviceEnv) -> tuple[float, float]:
    """Eq. 24."""
    T, E, P = env.T_max, env.E_max, env.P_com
    tp = P * T
    psi = 4.0 * tp * tp - 4.0 * E * tp + 9.0 * E * E
    root = math.sqrt(max(psi, 0.0))
    s1 = (root - 3.0 * E) / (8.0 * tp) + 0.75
    s2 = -(root + 3.0 * E) / (8.0 * tp) + 0.75
    return s1, s2


def solve(env: DeviceEnv) -> Strategy:
    """Closed-form per-device optimum (Eq. 25-26)."""
    lo, hi = phi_bounds(env)
    if lo > hi:
        # infeasible budgets: degrade gracefully to the cheapest settings
        return _recover(min(max(0.5, lo), 0.999), env)
    s1, s2 = stationary_points(env)
    candidates = [lo, hi] + [s for s in (s1, s2) if lo <= s <= hi]
    # rank by *projected* gain: when the recovered (alpha, beta, f) hits a
    # box constraint, the raw Eq.-21 objective over-estimates; evaluating
    # the realized strategy keeps the argmax faithful to Problem (P1).
    strategies = [_recover(p, env) for p in candidates]
    return max(strategies, key=lambda s: (s.feasible, s.gain))


def solve_population(envs: list[DeviceEnv]) -> list[Strategy]:
    """Each device decides locally (no cross-device information): its
    own :func:`solve`, in order."""
    return [solve(e) for e in envs]
