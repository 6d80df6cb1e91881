"""Inputs the benchmark makes from ``--seed`` and hands to both sides.

The program makes its data, fleet and initial weights from the seed it
is given (its own ``FLRunConfig.seed``); the reference makes them again
from the same seed.  The quantization uniforms are the one input the
program takes from its caller: :class:`SeededUniforms` is the source
both sides get.  Each draw is a ``torch.Generator`` on the run's device
seeded from ``(seed, stream, index)``, so the k-th device's uniforms are
the same numbers on both sides and on every call.
"""
from __future__ import annotations

import numpy as np
import torch


def child_seed(seed: int, *path: int) -> int:
    """A 63-bit seed derived from ``seed`` and ``path``; ``seed`` may be
    any non-negative integer."""
    ss = np.random.SeedSequence([seed, *path])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


class SeededUniforms:
    """The uniform source of one run (the program's ``UniformSource``)."""

    def __init__(self, seed: int, device):
        self.seed = seed
        self.device = torch.device(device)
        self.counts = [0, 0]

    def _draw(self, stream: int):
        s = child_seed(self.seed, 0x0F1B, stream, self.counts[stream])
        self.counts[stream] += 1
        dev = self.device

        def draw(n: int) -> torch.Tensor:
            gen = torch.Generator(device=dev).manual_seed(s)
            return torch.rand(n, generator=gen, device=dev)
        return draw

    def planner_stream(self):
        return self._draw(0)

    def device_stream(self):
        return self._draw(1)


def sample_devices(seed: int, n_devices: int, k: int) -> list[int]:
    """The devices whose round-0 updates are compared one by one."""
    rng = np.random.default_rng(child_seed(seed, 0x5A3))
    return sorted(int(i) for i in rng.choice(n_devices, size=min(k, n_devices),
                                             replace=False))


def step_sample(seed: int, t: int, n_devices: int, ids, k: int) -> set[int]:
    """Of the devices ``ids`` that train one width together in round
    ``t``, the ``k`` whose every local step is compared: those first in
    an order of the fleet's ``n_devices`` drawn from the seed."""
    rng = np.random.default_rng(child_seed(seed, 0x57E9, t))
    rank = rng.permutation(n_devices)
    return set(sorted((int(i) for i in ids), key=lambda i: rank[i])[:k])
