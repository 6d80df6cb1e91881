"""Host-side arithmetic of one AnycostFL round, in NumPy and Python.

Frozen copies of the port's synthetic data (``data/synthetic``,
``data/partition``), the wireless and fleet model (``sysmodel``), the
Problem-(P4) solver (``core/schedule``), HeteroFL's fixed-width strategy
(``train/baselines``), the width buckets and the minibatch draw.  They
consume one ``numpy`` generator in the order the port's round loop does,
so one seed gives the same data, fleet, channels and strategies.  The
reference imports nothing of the program: the copies are kept here so
that a change to the program cannot move the yardstick.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

ALPHA_BUCKETS = (0.25, 0.4, 0.55, 0.7, 0.85, 1.0)
HETEROFL_TIERS = (0.25, 0.5, 1.0)


# ------------------------------------------------------------------ data

def _class_templates(rng, n_classes, shape):
    h, w, c = shape
    t = rng.normal(0.5, 0.5, size=(n_classes, h, w, c))
    for _ in range(2):
        t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)
             + np.roll(t, 1, 2) + np.roll(t, -1, 2)) / 5.0
    return t


def _sample(rng, templates, n, noise):
    y = rng.integers(0, templates.shape[0], size=n).astype(np.int32)
    x = templates[y].copy()
    sx = rng.integers(-2, 3, size=n)
    sy = rng.integers(-2, 3, size=n)
    for i in range(n):
        x[i] = np.roll(np.roll(x[i], sx[i], 0), sy[i], 1)
    x = x + rng.normal(0, noise, size=x.shape)
    return np.clip(x, 0.0, 1.0).astype(np.float32), y


def image_task(rng, n_train, n_test, shape, noise=0.25):
    """((x, y) train, (x, y) test): class templates plus shifts and
    noise, NHWC float32 in [0, 1]."""
    templates = _class_templates(rng, 10, shape)
    return (_sample(rng, templates, n_train, noise),
            _sample(rng, templates, n_test, noise))


def partition_iid(rng, n_samples, n_clients):
    idx = rng.permutation(n_samples)
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


def device_batches(rng, idx, batch_size, tau):
    """(steps, B) sample indices: tau epochs of minibatches."""
    n = len(idx)
    bs = min(batch_size, n)
    steps = max(int(round(tau * n / bs)), 1)
    order = np.concatenate([rng.permutation(n)
                            for _ in range(math.ceil(steps * bs / n) + 1)])
    return idx[order[:steps * bs]].reshape(steps, bs)


# ----------------------------------------------------------- wireless, fleet

@dataclasses.dataclass(frozen=True)
class Wireless:
    """Eq. 8's FDMA uplink: log-distance path loss, Rayleigh fading."""
    cell_radius_m: float
    bandwidth_hz: float
    tx_power_w: float
    noise_dbm_per_mhz: float
    path_loss_exp: float
    ref_distance_m: float
    ref_loss_db: float


def _rates(rng, n, w: Wireless):
    r = w.cell_radius_m * np.sqrt(rng.uniform(size=n))
    theta = rng.uniform(0, 2 * np.pi, size=n)
    pos = np.stack([r * np.cos(theta), r * np.sin(theta)], -1)
    d = np.maximum(np.linalg.norm(pos, axis=-1), w.ref_distance_m)
    loss_db = w.ref_loss_db + 10 * w.path_loss_exp * np.log10(
        d / w.ref_distance_m)
    gain = 10 ** (-loss_db / 10) * rng.exponential(1.0, size=np.shape(d))
    n0_w = 10 ** ((w.noise_dbm_per_mhz - 30) / 10) * (w.bandwidth_hz / 1e6)
    return w.bandwidth_hz * np.log2(1.0 + gain * w.tx_power_w / n0_w)


@dataclasses.dataclass(frozen=True)
class Env:
    T_max: float
    E_max: float
    P_com: float
    rate: float
    W: float
    D: int
    tau: float
    eps_hw: float
    S_bits: float
    f_min: float
    f_max: float
    alpha_min: float
    beta_min: float
    beta_max: float


class Fleet:
    """The static fleet of a flat cell or of ``n_cells`` contiguous cells
    (radius scaled by ``1/sqrt(n_cells)``)."""

    def __init__(self, rng, fleet: dict, data_sizes, n_cells: int = 1):
        self.f = fleet
        n = fleet["n_devices"]
        lo, hi = fleet["eps_range"]
        mean, half = 0.5 * (lo + hi), 0.5 * (hi - lo)
        self.eps = np.clip(rng.uniform(mean - half, mean + half, n),
                           1e-28, None)
        self.e_max = rng.uniform(*fleet["E_max_range"], n)
        self.sizes = np.asarray(data_sizes)
        self.n_cells = n_cells
        self.cells = (np.arange(n) * n_cells) // n if n_cells > 1 else None
        base = Wireless(**fleet["wireless"])
        scale = 1.0 / math.sqrt(n_cells)
        self.wireless = dataclasses.replace(
            base, cell_radius_m=base.cell_radius_m * scale) \
            if n_cells > 1 else base

    def cell_of(self, i: int) -> int:
        return int(self.cells[i]) if self.cells is not None else 0

    def round_envs(self, rng, W, S_bits):
        n = self.f["n_devices"]
        if self.cells is None:
            rates = _rates(rng, n, self.wireless)
        else:
            rates = np.empty(n)
            for k in range(self.n_cells):
                idx = np.flatnonzero(self.cells == k)
                rates[idx] = _rates(rng, len(idx), self.wireless)
        f = self.f
        return [Env(T_max=f["T_max"], E_max=float(self.e_max[i]),
                    P_com=self.wireless.tx_power_w, rate=float(rates[i]),
                    W=W, D=int(self.sizes[i]), tau=f["tau"],
                    eps_hw=float(self.eps[i]), S_bits=S_bits,
                    f_min=f["f_min"], f_max=f["f_max"],
                    alpha_min=f["alpha_min"], beta_min=f["beta_min"],
                    beta_max=f["beta_max"]) for i in range(n)]


# ------------------------------------------------------------- strategies

@dataclasses.dataclass(frozen=True)
class Strategy:
    alpha: float
    beta: float
    feasible: bool


def _recover(phi, e: Env) -> Strategy:
    T, E, P = e.T_max, e.E_max, e.P_com
    work = e.tau * e.D * e.W
    varphi = min(max(1.0 - (1.0 - phi) * T * P / E, 0.0), 1.0)
    alpha = ((phi * T) ** 2 * varphi * E / (e.eps_hw * work ** 3)) \
        ** (1.0 / 3.0) if phi > 0 else e.alpha_min
    alpha = min(max(alpha, e.alpha_min), 1.0)
    beta = e.rate * (1.0 - phi) * T / (alpha * e.S_bits)
    beta = min(max(beta, e.beta_min), e.beta_max)
    freq = alpha * work / (phi * T) if phi > 0 else e.f_max
    freq = min(max(freq, e.f_min), e.f_max)
    t_cmp = alpha * work / freq
    e_cmp = e.eps_hw * freq ** 2 * alpha * work
    t_com = alpha * beta * e.S_bits / e.rate
    feasible = (t_cmp + t_com <= T * (1 + 1e-6)) and \
        (e_cmp + t_com * P <= E * (1 + 1e-6))
    return Strategy(alpha, beta, feasible), alpha ** 4 * beta


def solve(e: Env) -> Strategy:
    """Problem (P4) in closed form (Eq. 23-26)."""
    T = e.T_max
    work = e.tau * e.D * e.W
    lo = max(e.alpha_min * work / (e.f_max * T),
             1.0 - e.beta_max * e.S_bits / (e.rate * T))
    hi = min(work / (e.f_min * T) if e.f_min > 0 else 1.0,
             1.0 - e.alpha_min * e.beta_min * e.S_bits / (e.rate * T))
    lo, hi = max(lo, 1e-6), min(hi, 1.0 - 1e-6)
    if lo > hi:
        return _recover(min(max(0.5, lo), 0.999), e)[0]
    tp = e.P_com * T
    root = math.sqrt(max(4.0 * tp * tp - 4.0 * e.E_max * tp
                         + 9.0 * e.E_max * e.E_max, 0.0))
    s1 = (root - 3.0 * e.E_max) / (8.0 * tp) + 0.75
    s2 = -(root + 3.0 * e.E_max) / (8.0 * tp) + 0.75
    cands = [lo, hi] + [s for s in (s1, s2) if lo <= s <= hi]
    best = max((_recover(p, e) for p in cands),
               key=lambda sg: (sg[0].feasible, sg[1]))
    return best[0]


def fixed_width(e: Env, alpha: float, beta: float) -> Strategy:
    """HeteroFL's realized strategy at a fixed width and rate."""
    comm = alpha * beta * e.S_bits
    t_left = max(e.T_max - comm / e.rate, 1e-3)
    f = float(np.clip(alpha * e.tau * e.D * e.W / t_left, e.f_min, e.f_max))
    work = e.tau * e.D * e.W * alpha
    feasible = (work / f + comm / e.rate <= e.T_max * (1 + 1e-6)
                and e.eps_hw * f ** 2 * work + comm / e.rate * e.P_com
                <= e.E_max * (1 + 1e-6))
    return Strategy(alpha, beta, feasible)


def heterofl_tiers(eps) -> np.ndarray:
    """Compute-capability terciles: tier 0 for the least capable third."""
    return np.argsort(np.argsort(-eps)) * 3 // len(eps)


def bucket(alpha: float) -> float:
    below = [b for b in ALPHA_BUCKETS if b <= alpha + 1e-9]
    return below[-1] if below else ALPHA_BUCKETS[0]


def flops_per_sample(model: dict) -> float:
    """The paper's W: training FLOPs a sample (3 x the forward)."""
    c, d_ff, classes = model["d_model"], model["d_ff"], model["vocab_size"]
    if model["name"].startswith("fmnist"):
        fwd = (28 * 28 * 5 * 5 * 1 * c + 14 * 14 * 5 * 5 * c * 2 * c
               + 7 * 7 * 2 * c * d_ff + d_ff * classes) * 2
    else:
        fwd = (32 * 32 * 9 * (3 * c + c * c)
               + 16 * 16 * 9 * (c * 2 * c + 4 * c * c)
               + 8 * 8 * 9 * (2 * c * 4 * c + 16 * c * c)
               + 16 * 4 * c * d_ff + d_ff * d_ff + d_ff * 10) * 2
    return 3.0 * fwd
