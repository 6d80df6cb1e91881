"""Edge->cloud backhaul link model (client->edge->cloud topologies).

Each edge aggregator ships one payload per round however many uplinks it
absorbed: the streaming-AIO partial is the unnormalized ``(num, den)``
pair (``core/aggregation.PartialAgg``), so its wire size is a constant
multiple of the update size, set by the wire codec
(``topology/codec.py``): two float32 planes at ``f32`` (2.0), bf16
(1.0), or int8 planes (0.5 plus per-leaf scale headers), unless
``payload_factor`` overrides it.  The runner charges the codec's exact
encoded bit count through :meth:`ship_bits`.

Costs mirror the devices' Eq. 6-9: a fixed one-way latency plus
serialization at the provisioned rate, and an energy-per-bit tariff.
``BackhaulConfig.zero_cost()`` is the free link under which a 1-cell
hierarchy reproduces the flat single-cell run.

:func:`sample_cell_backhauls` draws one seeded log-uniform rate per cell
(a fibre-fed and a microwave-relay site differ by orders of magnitude),
from numpy's ``default_rng([seed, 0xBAC0, k])``, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.topology.codec import CODECS, payload_factor


@dataclasses.dataclass(frozen=True)
class BackhaulConfig:
    rate_bps: float = 1e9          # provisioned edge->cloud throughput
    latency_s: float = 0.01        # one-way propagation + handshake
    energy_per_bit: float = 0.0    # J/bit tariff of the hop
    codec: str = "f32"             # wire dtype of the shipped (num, den)
    # explicit override of the wire-size multiple; None -> derived from
    # the codec's encoded dtype (f32: 2.0, bf16: 1.0, int8: 0.5)
    payload_factor: Optional[float] = None
    # feed each round's bf16/int8 quantization error back into the next
    # round's shipped partial (per-cell residual held at the edge)
    error_feedback: bool = False

    def __post_init__(self):
        if self.rate_bps <= 0:
            raise ValueError("backhaul rate_bps must be > 0")
        if self.latency_s < 0 or self.energy_per_bit < 0:
            raise ValueError("backhaul latency/energy must be >= 0")
        if self.codec not in CODECS:
            raise ValueError(f"unknown backhaul codec {self.codec!r}; "
                             f"expected one of {CODECS}")
        if self.payload_factor is not None and self.payload_factor <= 0:
            raise ValueError("backhaul payload_factor must be > 0")

    @classmethod
    def zero_cost(cls) -> "BackhaulConfig":
        """A free, instantaneous link (the flat-equivalence case)."""
        return cls(rate_bps=math.inf, latency_s=0.0, energy_per_bit=0.0)

    @property
    def wire_factor(self) -> float:
        """Partial wire size / ``s_bits``: the override, else the
        codec's multiple."""
        if self.payload_factor is not None:
            return self.payload_factor
        return payload_factor(self.codec)

    def payload_bits(self, s_bits: float) -> float:
        """Modelled wire size of one shipped partial (headerless):
        :attr:`wire_factor` times the update's ``s_bits``."""
        return self.wire_factor * s_bits

    def ship_bits(self, bits: float) -> tuple[float, float]:
        """(latency_s, energy_j) of shipping ``bits`` over the hop."""
        t = self.latency_s + (bits / self.rate_bps
                              if math.isfinite(self.rate_bps) else 0.0)
        return t, bits * self.energy_per_bit

    def ship_cost(self, s_bits: float) -> tuple[float, float]:
        """(latency_s, energy_j) of shipping one modelled partial."""
        return self.ship_bits(self.payload_bits(s_bits))


def sample_cell_backhauls(base: BackhaulConfig, n_cells: int,
                          rate_range: tuple, *,
                          seed: int = 0) -> list[BackhaulConfig]:
    """One config per cell, the rate drawn log-uniformly over
    ``rate_range``; cell k's draw is a pure function of the seed and k."""
    lo, hi = float(rate_range[0]), float(rate_range[1])
    if not 0 < lo <= hi:
        raise ValueError("rate_range must satisfy 0 < lo <= hi")
    out = []
    for k in range(n_cells):
        u = np.random.default_rng([seed, 0xBAC0, k]).uniform()
        rate = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        out.append(dataclasses.replace(base, rate_bps=rate))
    return out
