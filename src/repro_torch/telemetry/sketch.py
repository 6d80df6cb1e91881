"""Bounded-memory, mergeable, deterministic telemetry sketches.

Three fleet-scale primitives back the ``--telemetry-rollup`` path:

* :class:`QuantileSketch` — a fixed-capacity streaming quantile sketch
  built on **blake2b bottom-k retention**: each observation is tagged
  with ``blake2b(salt ‖ sequence_index)`` and the sketch keeps the ``k``
  entries with the smallest digests.  Because the digest depends only on
  the (salt, index) pair — never on wall-clock time or an RNG stream —
  the retained sample is a pure function of the emission sequence, which
  is what the ``repro.analysis`` unseeded-randomness contract demands.
  While ``count <= capacity`` *every* observation is retained, so small
  runs are exact by construction (the bitwise small-run guard for
  ``MetricsRegistry.summary``).  Merging is a multiset union sorted by
  ``(digest, value)`` and truncated to ``k`` — associative and
  commutative bitwise, so per-cell sketches can be combined in any
  order (cross-run ``query diff``, hierarchical rollup).
* :class:`TopK` — a bounded heavy-hitter tracker keeping the K largest
  ``(value, key)`` observations under a deterministic total order
  (value, then blake2b(key) as tie-break).  Surfaces the top straggler
  / energy-hog devices per (cell, phase, round) without retaining all N
  device rows.
* :class:`RollupPolicy` — the knob bundle: fleet-size threshold at
  which device-labeled emissions fold into per-cell sketches, sketch
  capacity, top-K width, and the hash seed.

Nothing in this module reads a clock or an RNG; every structure is a
pure function of (seed, emission sequence) and is therefore bitwise
replay-stable.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import math
from typing import Iterable, Optional

#: digests are 8 bytes -> 64-bit ints (JSON-safe, collision odds ~2^-64
#: per pair at telemetry scales)
_DIGEST_BYTES = 8
_HASH_SPACE = float(2 ** (8 * _DIGEST_BYTES))

SKETCH_KEY = "__sketch__"
TOPK_KEY = "__topk__"


def _digest(salt: str, token: str) -> int:
    """64-bit blake2b digest of ``salt ‖ token`` as an int."""
    h = hashlib.blake2b(f"{salt}|{token}".encode(),
                        digest_size=_DIGEST_BYTES)
    return int.from_bytes(h.digest(), "big")


def hash01(salt: str, token: str) -> float:
    """Deterministic uniform-ish mapping of ``token`` into [0, 1)."""
    return _digest(salt, token) / _HASH_SPACE


def bottom_k(keys: Iterable, k: int, seed: int = 0) -> list:
    """The ``k`` keys with the smallest ``blake2b(seed ‖ key)`` digests.

    Sample-stability contract: growing the key set never evicts a
    surviving member in favor of a key it already beat — the bottom-k of
    a superset, intersected with the subset, is contained in the
    bottom-k of the subset (property-tested).
    """
    salt = f"bk|{seed}"
    ranked = sorted((( _digest(salt, repr(key)), key) for key in keys),
                    key=lambda dk: (dk[0], repr(dk[1])))
    return [key for _, key in ranked[:k]]


class QuantileSketch:
    """Fixed-capacity quantile sketch with exact moments.

    ``count``/``min``/``max`` are exact under both :meth:`add` and
    :meth:`merge`; ``sum`` is a float accumulation (exact per-add, merge
    adds partial sums).  Quantiles interpolate over the retained sample
    using the same closest-ranks rule as ``MetricsRegistry.summary`` —
    exact while ``count <= capacity``, within :meth:`rank_error_bound`
    of the true rank afterwards.
    """

    __slots__ = ("capacity", "salt", "count", "sum", "min", "max",
                 "_entries")

    def __init__(self, capacity: int = 512, salt: str = ""):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.salt = salt
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        #: sorted list of (digest, value); len <= capacity
        self._entries: list[tuple[int, float]] = []

    # ------------------------------------------------------------- update

    def add(self, value) -> None:
        v = float(value)
        entry = (_digest(self.salt, str(self.count)), v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._entries) < self.capacity:
            bisect.insort(self._entries, entry)
        elif entry < self._entries[-1]:
            bisect.insort(self._entries, entry)
            self._entries.pop()

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Non-mutating merge; associative and commutative bitwise on
        (count, min, max, retained entries); ``sum`` is float addition
        (commutative; associative to ~1 ulp)."""
        out = QuantileSketch(max(self.capacity, other.capacity),
                             salt=self.salt or other.salt)
        out.count = self.count + other.count
        out.sum = self.sum + other.sum
        mins = [m for m in (self.min, other.min) if m is not None]
        maxs = [m for m in (self.max, other.max) if m is not None]
        out.min = min(mins) if mins else None
        out.max = max(maxs) if maxs else None
        out._entries = sorted(self._entries + other._entries)[:out.capacity]
        return out

    # ------------------------------------------------------------ queries

    @property
    def exact(self) -> bool:
        """True while every observation is retained."""
        return self.count == len(self._entries)

    def values(self) -> list[float]:
        """Retained sample values (digest order — replay-stable)."""
        return [v for _, v in self._entries]

    def rank_error_bound(self) -> float:
        """Declared additive rank-error bound for quantile estimates.

        Bottom-k over per-observation hashes retains a uniform k-subset
        of the stream, so the q-th sample quantile's rank error is
        ~Normal(0, sqrt(q(1-q)/k)); 0 when the sketch is still exact.
        Bound = 4 standard deviations at the worst case q = 1/2.
        """
        if self.exact or not self._entries:
            return 0.0
        return 4.0 * math.sqrt(0.25 / len(self._entries))

    def quantile(self, q: float) -> Optional[float]:
        """Linear interpolation between closest ranks of the retained
        sample (numpy's default method, matching registry.summary)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if not self._entries:
            return None
        vals = sorted(v for _, v in self._entries)
        rank = q * (len(vals) - 1)
        lo = int(rank)
        hi = min(lo + 1, len(vals) - 1)
        frac = rank - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac

    # ------------------------------------------------------------- export

    def to_dict(self) -> dict:
        """JSON-ready state; round-trips bitwise via :meth:`from_dict`."""
        return {SKETCH_KEY: {
            "capacity": self.capacity, "salt": self.salt,
            "count": self.count, "sum": self.sum,
            "min": self.min, "max": self.max,
            "entries": [[d, v] for d, v in self._entries]}}

    @classmethod
    def from_dict(cls, doc: dict) -> "QuantileSketch":
        body = doc[SKETCH_KEY]
        sk = cls(body["capacity"], salt=body.get("salt", ""))
        sk.count = int(body["count"])
        sk.sum = float(body["sum"])
        sk.min = body["min"]
        sk.max = body["max"]
        sk._entries = [(int(d), float(v)) for d, v in body["entries"]]
        return sk

    @staticmethod
    def is_doc(value) -> bool:
        return isinstance(value, dict) and SKETCH_KEY in value

    def __repr__(self) -> str:
        return (f"QuantileSketch(capacity={self.capacity}, "
                f"count={self.count}, retained={len(self._entries)})")


class TopK:
    """Bounded top-K (largest value) tracker over (key, value) pairs.

    Repeated adds for a retained key keep that key's maximum; a key can
    only be forgotten while outside the retained set (the bounded-memory
    approximation).  Total order for ties: value desc, then
    ``blake2b(salt ‖ key)``, then ``str(key)`` — fully deterministic.
    """

    __slots__ = ("k", "salt", "_entries")

    def __init__(self, k: int = 8, salt: str = ""):
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        self.k = int(k)
        self.salt = salt
        #: sorted desc by (value, -) — stored as list of (value, digest, key)
        self._entries: list[tuple[float, int, str]] = []

    def _rank(self, value: float, key) -> tuple:
        s = str(key)
        return (-value, _digest(self.salt, s), s)

    def add(self, key, value) -> None:
        v = float(value)
        s = str(key)
        for i, (have_v, _, have_k) in enumerate(self._entries):
            if have_k == s:
                if v > have_v:
                    del self._entries[i]
                    break
                return
        entry = (v, _digest(self.salt, s), s)
        self._entries.append(entry)
        self._entries.sort(key=lambda e: (-e[0], e[1], e[2]))
        del self._entries[self.k:]

    def merge(self, other: "TopK") -> "TopK":
        out = TopK(max(self.k, other.k), salt=self.salt or other.salt)
        best: dict[str, tuple[float, int, str]] = {}
        for e in self._entries + other._entries:
            have = best.get(e[2])
            if have is None or e[0] > have[0]:
                best[e[2]] = e
        out._entries = sorted(best.values(),
                              key=lambda e: (-e[0], e[1], e[2]))[:out.k]
        return out

    def items(self) -> list[tuple[str, float]]:
        """``[(key, value), ...]`` best-first."""
        return [(k, v) for v, _, k in self._entries]

    def to_dict(self) -> dict:
        return {TOPK_KEY: {"k": self.k, "salt": self.salt,
                           "entries": [[k, v] for k, v in self.items()]}}

    @classmethod
    def from_dict(cls, doc: dict) -> "TopK":
        body = doc[TOPK_KEY]
        tk = cls(body["k"], salt=body.get("salt", ""))
        for key, value in body["entries"]:
            tk.add(key, value)
        return tk

    @staticmethod
    def is_doc(value) -> bool:
        return isinstance(value, dict) and TOPK_KEY in value

    def __repr__(self) -> str:
        return f"TopK(k={self.k}, tracked={len(self._entries)})"


@dataclasses.dataclass(frozen=True)
class RollupPolicy:
    """When and how device-labeled emissions fold into per-cell sketches.

    Rollup engages once :meth:`MetricsRegistry.set_fleet_size` reports a
    fleet at or above ``device_threshold``; below it, telemetry keeps
    the exact per-device cells and stays bitwise-identical to a registry
    constructed without a policy.
    """
    device_threshold: int = 1024
    sketch_capacity: int = 512
    top_k: int = 8
    seed: int = 0
    #: the high-cardinality label stripped by rollup
    drop_label: str = "device"

    def engages(self, fleet_size: int) -> bool:
        return fleet_size >= self.device_threshold

    def salt_for(self, name: str, label_key: tuple) -> str:
        return f"{name}|{label_key!r}|{self.seed}"
