"""Baseline files: grandfathered findings that do not fail the gate.

A baseline is a committed JSON snapshot of known findings.  Matching is
a multiset over :meth:`Finding.key` — ``(file, rule, message)``, line
numbers deliberately excluded so unrelated edits do not churn it.  The
gate fails only on findings *not* covered by the baseline; stale
baseline entries (fixed findings) are reported so the file can be
re-tightened with ``--write-baseline``.
"""
from __future__ import annotations

import json
from collections import Counter
from typing import Iterable

from repro_torch.analysis.engine import Finding

DEFAULT_BASELINE = "ANALYSIS_BASELINE_TORCH.json"
_VERSION = 1


def save_baseline(path: str, findings: Iterable[Finding]) -> None:
    records = [{"file": f.file, "rule": f.rule, "message": f.message}
               for f in sorted(findings)]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"version": _VERSION, "findings": records}, fh,
                  indent=1, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> Counter:
    with open(path, encoding="utf-8") as fh:
        data = json.load(fh)
    if not isinstance(data, dict) or data.get("version") != _VERSION:
        raise ValueError(f"{path}: not a v{_VERSION} analysis baseline")
    out: Counter = Counter()
    for rec in data.get("findings", []):
        out[(rec["file"], rec["rule"], rec["message"])] += 1
    return out


def apply_baseline(findings: list[Finding], baseline: Counter
                   ) -> tuple[list[Finding], list[Finding], Counter]:
    """Split into (new, grandfathered) findings + stale baseline keys."""
    budget = Counter(baseline)
    new: list[Finding] = []
    old: list[Finding] = []
    for f in findings:
        if budget[f.key()] > 0:
            budget[f.key()] -= 1
            old.append(f)
        else:
            new.append(f)
    stale = Counter({k: v for k, v in budget.items() if v > 0})
    return new, old, stale
