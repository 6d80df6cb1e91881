"""Deterministic hash-based trace sampling (``--trace-sample``).

The determinism contract: a device is traced **iff**
``blake2b(seed ‖ device_id) / 2^64 < rate``.  The decision is a pure
function of (seed, device_id) — never of RNG state, arrival order, or
wall-clock — so the same devices are traced on every replay of a seeded
run, sampled traces from two runs are directly comparable, and the
event-queue trace signature (which hashes simulation events, not
telemetry) is untouched.

Only the high-cardinality ``device/<id>`` track group is sampled by
default; ``server``, ``cell/<i>``, and other O(cells) rows are always
kept.
"""
from __future__ import annotations

from repro_torch.telemetry.sketch import hash01


def sampled(seed: int, key, rate: float) -> bool:
    """True iff ``key`` falls inside the deterministic ``rate`` slice."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return hash01(f"trace|{seed}", str(key)) < rate


class TraceSampler:
    """Per-track keep/drop policy for a :class:`~repro_torch.telemetry.trace.
    TraceSink`.

    ``groups`` names the track groups subject to sampling (a track is
    ``"<group>/<id>"`` or a bare group name); tracks outside those
    groups are always kept.  Only *kept* tracks are cached — a cache
    over every track seen would itself be O(devices), exactly the
    growth this module exists to remove; dropped tracks just re-hash
    (one blake2b per event, stateless).
    """

    __slots__ = ("rate", "seed", "groups", "n_dropped", "_kept")

    def __init__(self, rate: float, seed: int = 0,
                 groups: tuple[str, ...] = ("device",)):
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"sample rate {rate} outside [0, 1]")
        self.rate = float(rate)
        self.seed = int(seed)
        self.groups = tuple(groups)
        self.n_dropped = 0
        self._kept: set[str] = set()

    def keep(self, track: str) -> bool:
        """Whether events on ``track`` are recorded (replay-stable)."""
        if track in self._kept:
            return True
        group, sep, ident = track.partition("/")
        dec = (group not in self.groups or not sep
               or sampled(self.seed, ident, self.rate))
        if dec:
            self._kept.add(track)
        else:
            self.n_dropped += 1
        return dec

    def describe(self) -> dict:
        """Provenance stamp for trace exports."""
        return {"rate": self.rate, "seed": self.seed,
                "groups": list(self.groups),
                "n_dropped_events": self.n_dropped}
