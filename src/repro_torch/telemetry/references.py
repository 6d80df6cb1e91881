"""Machine-checked perf references: typed tolerances over scalar metrics.

ReFrame-style regression checking for the benchmark trajectory: every
scalar a benchmark section emits can declare a :class:`Reference` —
*how* its value is allowed to move between runs — and
:func:`check_reference` turns (value, baseline, reference) into a
:class:`Verdict` a gate can print and exit on.

Directions:

* ``lower_is_better``  — regressions are values *above* the allowed
  band; improvements (arbitrarily lower) always pass;
* ``higher_is_better`` — the mirror image;
* ``exact``            — any deviation beyond the tolerances fails
  (replay signatures, invariant byte counts, flags).

The allowed band around a baseline ``b`` is
``|value - b| <= abs_tol + rel_tol * |b|`` on the regression side —
the same shape as ``math.isclose`` but one-sided for the directional
modes.  A reference may pin its own ``baseline`` (an absolute contract,
e.g. *telemetry-overhead bytes == 0*); otherwise the baseline comes from
the trajectory store's pinned record and a missing one yields ``SKIP``,
never a silent pass-as-fail.

Metric values are extracted from artifact dicts (never parsed from
stdout) via :func:`extract_path` dotted paths — ``memory.-1.
streaming_peak_bytes`` walks dict keys and list indices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

LOWER = "lower_is_better"
HIGHER = "higher_is_better"
EXACT = "exact"

DIRECTIONS = (LOWER, HIGHER, EXACT)

PASS = "PASS"
FAIL = "FAIL"
SKIP = "SKIP"


@dataclasses.dataclass(frozen=True)
class Reference:
    """Declared tolerance for one scalar metric.

    ``path`` locates the value inside the section's artifact dict;
    ``baseline`` (optional) pins an absolute expected value — when
    ``None`` the gate supplies the trajectory baseline instead.
    """

    path: str
    direction: str = LOWER
    rel_tol: float = 0.0
    abs_tol: float = 0.0
    baseline: Optional[float] = None
    unit: str = ""
    note: str = ""

    def __post_init__(self):
        if self.direction not in DIRECTIONS:
            raise ValueError(f"direction {self.direction!r} not one of "
                             f"{DIRECTIONS}")
        if self.rel_tol < 0 or self.abs_tol < 0:
            raise ValueError("tolerances must be non-negative")


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Outcome of checking one metric against its reference."""

    path: str
    status: str                    # PASS | FAIL | SKIP
    value: Optional[float] = None
    baseline: Optional[float] = None
    note: str = ""

    @property
    def delta(self) -> Optional[float]:
        if self.value is None or self.baseline is None:
            return None
        return self.value - self.baseline


def extract_path(obj: Any, path: str):
    """Walk ``obj`` along a dotted path; ``None`` when any hop misses.

    Segments index dicts by key (int keys tried when the string form
    misses) and lists/tuples by (possibly negative) integer position.
    """
    cur = obj
    for seg in path.split("."):
        if isinstance(cur, dict):
            if seg in cur:
                cur = cur[seg]
                continue
            try:
                cur = cur[int(seg)]
                continue
            except (KeyError, ValueError):
                return None
        elif isinstance(cur, (list, tuple)):
            try:
                cur = cur[int(seg)]
                continue
            except (IndexError, ValueError):
                return None
        else:
            return None
    return cur


def as_scalar(value) -> Optional[float]:
    """Coerce a metric value to float (bools allowed); None otherwise."""
    if isinstance(value, bool):
        return float(value)
    if isinstance(value, (int, float)):
        v = float(value)
        return v if math.isfinite(v) else None
    return None


def check_reference(value, baseline, ref: Reference) -> Verdict:
    """One metric's verdict under its declared reference.

    ``value`` is the newest run's metric; ``baseline`` the trajectory
    baseline (ignored when the reference pins its own).  Missing value
    or missing baseline -> SKIP (the gate reports, never guesses).
    """
    v = as_scalar(value)
    if v is None:
        return Verdict(ref.path, SKIP, note="metric missing from record")
    b = as_scalar(ref.baseline if ref.baseline is not None else baseline)
    if b is None:
        return Verdict(ref.path, SKIP, value=v,
                       note="no baseline (run gate --update-baseline)")
    band = ref.abs_tol + ref.rel_tol * abs(b)
    if ref.direction == EXACT:
        ok = abs(v - b) <= band
    elif ref.direction == LOWER:
        ok = v <= b + band
    else:                                    # HIGHER
        ok = v >= b - band
    note = ref.note
    if not ok:
        note = (f"{ref.direction}: |Δ|={abs(v - b):.6g} "
                f"> tol={band:.6g}")
    return Verdict(ref.path, PASS if ok else FAIL, value=v, baseline=b,
                   note=note)


def check_record(metrics: dict, baseline_metrics: Optional[dict],
                 refs: list[Reference]) -> list[Verdict]:
    """Check a flat ``{path: value}`` metrics record against its
    references; baseline values come from ``baseline_metrics`` keyed by
    the same paths."""
    out = []
    for ref in refs:
        base = None if baseline_metrics is None \
            else baseline_metrics.get(ref.path)
        out.append(check_reference(metrics.get(ref.path), base, ref))
    return out
