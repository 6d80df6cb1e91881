"""The paper's five comparison methods (§V-B), and FedAvg.

Every baseline produces the ``(values, mask, bits)`` interface that the
averaging server consumes, plus a per-device *resource policy* that maps
a DeviceEnv to (alpha, beta, f): the baselines keep their published
behaviour (compression-only or width-only) and fit the computing
frequency to the latency budget where they can; when a budget cannot be
met the realized (violated) cost is recorded, which is the effect
Table I and Fig. 5 measure.

  STC       sparse ternary compression [11]: elementwise top-k, sign *
            mean-magnitude values, Golomb-coded mask.
  QSGD      top-k + probabilistic scalar quantization [36].
  UVeQFed   top-k + subtractive-dithered uniform (lattice) quantization [14].
  HeteroFL  static per-tier sub-model widths, no gradient compression [32].
  FedHQ     full model, per-device quantization level from the channel
            state; aggregation weights minimize the quantization-noise
            bound [40].
  FedAvg    full model, full precision.

QSGD and FedHQ quantize through the ``prob_quantize`` kernel
(``kernels/ops.py``: the kernel for CUDA tensors, the plain version for
CPU ones).  Randomness is an input, as in ``core/compression.py``: where
the reference draws from the device's key, these compressors take
``rand``, one float32 uniform in [0, 1) per element of the flat update.
UVeQFed's dither is ``rand - 0.5``, which is bitwise what the reference
draws from the same key with ``minval=-0.5, maxval=0.5``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import compression
from repro_torch.core.schedule import DeviceEnv, Strategy
from repro_torch.kernels import ops
from repro_torch.utils.pytree import flatten_to_vector, tree_size

PyTree = Any
F32 = torch.float32


class Compressed(NamedTuple):
    values: PyTree
    mask: PyTree
    bits: torch.Tensor       # modelled wire size (0-d float32)


# ------------------------------------------------------------- compressors

def _topk_mask(vec: torch.Tensor, keep_frac: float) -> torch.Tensor:
    """Elementwise top-k by magnitude, ``k = max(int(keep_frac * N), 1)``:
    the threshold is the exact k-th largest ``|v|``, ties kept.  Taken
    by a sort: on an H100, ``torch.kthvalue`` takes about 45 times as
    long at the fmnist-cnn size."""
    k = max(int(keep_frac * vec.numel()), 1)
    av = vec.abs()
    return (av >= torch.sort(av).values[-k]).to(vec.dtype)


def _quantize(vec: torch.Tensor, mask: torch.Tensor, n_levels,
              rand: torch.Tensor) -> compression.Quantized:
    """Eq. 3-4 of the masked elements: the masked range, then one
    ``prob_quantize`` launch with the scalars as arguments."""
    u_min, u_max = compression.masked_range(vec, mask)
    u_min_f, u_max_f = torch.stack([u_min, u_max]).tolist()
    values, levels = ops.prob_quantize_op(vec, mask, u_min_f, u_max_f,
                                          float(n_levels), rand)
    return compression.Quantized(values, levels, u_min, u_max)


def stc_compress(update: PyTree, keep_frac: float) -> Compressed:
    """Sparse ternary: values -> sign * mean(|kept|)."""
    vec, unflatten = flatten_to_vector(update)
    mask = _topk_mask(vec, keep_frac)
    mu = (vec.abs() * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    tern = torch.sign(vec) * mu * mask
    bits = compression.golomb_bits(mask) + mask.sum() + 32.0
    return Compressed(unflatten(tern), unflatten(mask), bits)


def qsgd_compress(update: PyTree, keep_frac: float, n_levels: int,
                  rand: torch.Tensor) -> Compressed:
    vec, unflatten = flatten_to_vector(update)
    mask = _topk_mask(vec, keep_frac)
    q = _quantize(vec, mask, n_levels, rand)
    bits = compression.compressed_bits(q, mask, n_levels)
    return Compressed(unflatten(q.values * mask), unflatten(mask), bits)


def dither_quantize(vec: torch.Tensor, mask: torch.Tensor, n_levels: int,
                    rand: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """UVeQFed's subtractive-dithered uniform quantizer over the masked
    range ``[-vmax, vmax]`` in ``n_levels`` steps, dither ``rand - 0.5``:
    (dequantized values, 0 where masked; int32 level magnitudes)."""
    vmax = (vec.abs() * mask).max()
    delta = 2.0 * torch.clamp(vmax, min=1e-12) / n_levels
    dither = rand - 0.5
    idx = torch.round(vec / delta + dither)
    deq = (idx - dither) * delta * mask
    return deq, torch.clamp(idx.abs(), 0, n_levels).to(torch.int32)


def uveqfed_compress(update: PyTree, keep_frac: float, n_levels: int,
                     rand: torch.Tensor) -> Compressed:
    """Top-k, then the subtractive-dithered quantizer (scalar lattice)."""
    vec, unflatten = flatten_to_vector(update)
    mask = _topk_mask(vec, keep_frac)
    deq, lvl = dither_quantize(vec, mask, n_levels, rand)
    bits = compression.entropy_bits(lvl, mask, n_levels) \
        + compression.golomb_bits(mask) + 64.0
    return Compressed(unflatten(deq), unflatten(mask), bits)


def fedhq_compress(update: PyTree, n_levels: int,
                   rand: torch.Tensor) -> Compressed:
    """Full-coordinate probabilistic quantization (no sparsification)."""
    vec, unflatten = flatten_to_vector(update)
    mask = torch.ones_like(vec)
    q = _quantize(vec, mask, n_levels, rand)
    bits = compression.compressed_bits(q, mask, n_levels)
    return Compressed(unflatten(q.values), unflatten(mask), bits)


def identity_compress(update: PyTree) -> Compressed:
    """HeteroFL and FedAvg: the raw float32 update, every element sent."""
    vec, unflatten = flatten_to_vector(update)
    bits = torch.tensor(vec.numel() * 32.0, dtype=F32, device=vec.device)
    return Compressed(unflatten(vec), unflatten(torch.ones_like(vec)), bits)


# --------------------------------------------------------- resource policies

def fit_frequency(env: DeviceEnv, alpha: float, comm_bits: float) -> float:
    """Smallest f meeting the latency budget after comm; clipped to range."""
    t_com = comm_bits / env.rate
    t_left = max(env.T_max - t_com, 1e-3)
    f = alpha * env.tau * env.D * env.W / t_left
    return float(np.clip(f, env.f_min, env.f_max))


def realized_strategy(env: DeviceEnv, alpha: float, beta: float) -> Strategy:
    comm_bits = alpha * beta * env.S_bits
    f = fit_frequency(env, alpha, comm_bits)
    work = env.tau * env.D * env.W * alpha
    t_cmp = work / f
    e_cmp = env.eps_hw * f ** 2 * work
    t_com = comm_bits / env.rate
    e_com = t_com * env.P_com
    return Strategy(alpha=alpha, beta=beta, freq=f, phi=0.0, varphi=0.0,
                    gain=alpha ** 4 * beta, T_cmp=t_cmp, T_com=t_com,
                    E_cmp=e_cmp, E_com=e_com,
                    feasible=(t_cmp + t_com <= env.T_max * (1 + 1e-6)
                              and e_cmp + e_com <= env.E_max * (1 + 1e-6)))


@dataclasses.dataclass(frozen=True)
class BaselinePolicy:
    name: str
    keep_frac: float = 1.0 / 16.0     # top-k kept fraction (STC/QSGD/UVeQFed)
    n_levels: int = 16
    # HeteroFL width tiers, assigned by device compute capability terciles
    width_tiers: tuple = (0.25, 0.5, 1.0)

    def strategy(self, env: DeviceEnv, tier: int = 2) -> Strategy:
        if self.name == "heterofl":
            alpha = self.width_tiers[tier]
            return realized_strategy(env, alpha, 1.0)
        if self.name == "fedhq":
            # pick L so the (entropy-free) wire size fits the latency left
            # after computing at f_max/2: bits/elem = log2(L)+1
            levels = self.fedhq_levels(env)
            beta = (np.log2(levels) + 1.0) / 32.0
            return realized_strategy(env, 1.0, float(beta))
        if self.name == "fedavg":
            return realized_strategy(env, 1.0, 1.0)
        # compression-only: rate implied by keep_frac + levels
        bpe_kept = np.log2(self.n_levels) + 1.0
        beta = self.keep_frac * (bpe_kept / 32.0) \
            + 0.05 * self.keep_frac       # + mask overhead estimate
        return realized_strategy(env, 1.0, float(beta))

    def fedhq_levels(self, env: DeviceEnv) -> int:
        """FedHQ's level count; up to 2**16 = 65536, not clipped to the
        16-bit header's range, as in the reference."""
        n_bits_budget = max(env.rate * env.T_max * 0.5, 1.0)
        n_elems = env.S_bits / 32.0
        bpe = np.clip(n_bits_budget / n_elems - 1.0, 1.0, 16.0)
        return max(int(2 ** bpe), 2)

    def compress(self, update: PyTree, env: DeviceEnv,
                 draw: Callable[[int], torch.Tensor]) -> Compressed:
        """``draw(n)``: the device's n uniforms, taken only by the methods
        that quantize at random (QSGD, UVeQFed, FedHQ)."""
        if self.name == "stc":
            return stc_compress(update, self.keep_frac)
        if self.name in ("heterofl", "fedavg"):
            return identity_compress(update)
        rand = draw(tree_size(update))
        if self.name == "qsgd":
            return qsgd_compress(update, self.keep_frac, self.n_levels, rand)
        if self.name == "uveqfed":
            return uveqfed_compress(update, self.keep_frac, self.n_levels,
                                    rand)
        if self.name == "fedhq":
            return fedhq_compress(update, self.fedhq_levels(env), rand)
        raise ValueError(f"unknown baseline {self.name!r}")


def fedhq_weights(levels: list[int]) -> torch.Tensor:
    """FedHQ [40]: p* ∝ 1/(1 + quantization-noise coefficient), in float64,
    cast to float32 once."""
    noise = np.array([1.0 / (4.0 * L * L) for L in levels])
    inv = 1.0 / (1.0 + noise)
    return torch.from_numpy((inv / inv.sum()).astype(np.float32))
