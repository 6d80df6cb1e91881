"""Computation / communication cost models (paper Eq. 6-9).

Per-device cost functions in Python floats and the Jetson-family
platform profiles, as the reference keeps them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """A hardware platform (the paper measures Jetson Nano / NX / Xavier)."""
    name: str
    f_min: float        # cycles/s
    f_max: float
    eps_hw: float       # J/(cycle/s)^2/cycle (Eq. 7)


# Jetson-family-like profiles (relative capability ratios follow Fig. 1)
JETSON_NANO = DeviceProfile("nano", 0.3e9, 0.9e9, 9e-27)
JETSON_NX = DeviceProfile("nx-agx", 0.5e9, 1.4e9, 7e-27)
JETSON_XAVIER = DeviceProfile("xavier-agx", 0.8e9, 2.3e9, 5e-27)
PROFILES = (JETSON_NANO, JETSON_NX, JETSON_XAVIER)


def compute_time(alpha: float, W: float, D: int, tau: float,
                 freq: float) -> float:
    """Eq. 6: T_cmp = tau * |D| * alpha * W / f."""
    return tau * D * alpha * W / freq


def compute_energy(alpha: float, W: float, D: int, tau: float, freq: float,
                   eps_hw: float) -> float:
    """Eq. 7: E_cmp = eps * f^2 * tau * |D| * alpha * W."""
    return eps_hw * freq ** 2 * tau * D * alpha * W


def comm_time(alpha: float, beta: float, S_bits: float, rate: float) -> float:
    """Eq. 9: T_com = alpha * beta * S / r."""
    return alpha * beta * S_bits / rate


def comm_energy(alpha: float, beta: float, S_bits: float, rate: float,
                tx_power_w: float) -> float:
    """Eq. 9: E_com = T_com * P."""
    return comm_time(alpha, beta, S_bits, rate) * tx_power_w


def round_cost(alpha, beta, freq, *, W, D, tau, eps_hw, S_bits, rate,
               tx_power_w):
    """(latency, energy) of one local round at the given strategy."""
    t_cmp = compute_time(alpha, W, D, tau, freq)
    e_cmp = compute_energy(alpha, W, D, tau, freq, eps_hw)
    t_com = comm_time(alpha, beta, S_bits, rate)
    e_com = comm_energy(alpha, beta, S_bits, rate, tx_power_w)
    return t_cmp + t_com, e_cmp + e_com
