"""Wireless system model (paper §IV-A.2 and §V-A.2), numpy only.

FDMA uplink: r = b log2(1 + |h| P / (N0 b)) with distance-dependent path
loss (exponent 3.76, urban macro), devices placed uniformly in a 550 m cell
and re-dropped each round (the paper's i.i.d. mobility proxy, [44]).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WirelessConfig:
    cell_radius_m: float = 550.0
    bandwidth_hz: float = 1e6           # 1 MHz per device (§V-A.2)
    tx_power_w: float = 0.1             # 0.1 W
    noise_dbm_per_mhz: float = -114.0   # N0
    path_loss_exp: float = 3.76
    ref_distance_m: float = 1.0
    ref_loss_db: float = 35.0           # loss at 1 m (2 GHz-ish macro)


def drop_positions(rng: np.random.Generator, n: int,
                   cfg: WirelessConfig) -> np.ndarray:
    """Uniform positions in the cell (radius sampling ~ sqrt for uniform)."""
    r = cfg.cell_radius_m * np.sqrt(rng.uniform(size=n))
    theta = rng.uniform(0, 2 * np.pi, size=n)
    return np.stack([r * np.cos(theta), r * np.sin(theta)], -1)


def path_gain(distance_m: np.ndarray, cfg: WirelessConfig,
              rng: np.random.Generator | None = None) -> np.ndarray:
    """Linear channel gain |h| with log-distance path loss (+ Rayleigh
    fading when an rng is provided)."""
    d = np.maximum(distance_m, cfg.ref_distance_m)
    loss_db = cfg.ref_loss_db + 10 * cfg.path_loss_exp * np.log10(
        d / cfg.ref_distance_m)
    gain = 10 ** (-loss_db / 10)
    if rng is not None:
        # unit-mean exponential (Rayleigh power fading)
        gain = gain * rng.exponential(1.0, size=np.shape(d))
    return gain


def achievable_rate(distance_m: np.ndarray, cfg: WirelessConfig,
                    tx_power_w: float | None = None,
                    rng: np.random.Generator | None = None) -> np.ndarray:
    """Eq. 8 — bits/s."""
    p = cfg.tx_power_w if tx_power_w is None else tx_power_w
    n0_w = 10 ** ((cfg.noise_dbm_per_mhz - 30) / 10) * \
        (cfg.bandwidth_hz / 1e6)
    g = path_gain(distance_m, cfg, rng)
    snr = g * p / n0_w
    return cfg.bandwidth_hz * np.log2(1.0 + snr)
