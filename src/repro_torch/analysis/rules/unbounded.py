"""unbounded-telemetry: no open-ended list aggregation in telemetry/.

The fleet-scale contract: telemetry host memory must be bounded
in device count — device-labeled series go through fixed-capacity
:class:`~repro_torch.telemetry.sketch.QuantileSketch` / ``TopK`` structures,
never through per-label Python lists that grow one entry per
observation.  The failure mode this rule catches is the one that made
``dispatch.latency_s`` unbounded over long fedbuff runs: an innocuous

    series.setdefault(label_key, []).append(value)

(or ``d[key].append(value)``) inside the telemetry package, keyed by a
high-cardinality label row, accumulating forever.

Scope: files under a ``telemetry/`` directory only — everywhere else,
list appends are ordinary Python.  Flagged shapes, both receivers of an
``.append(...)`` call:

* a subscript — ``cells[key].append(v)``;
* a ``.setdefault(...)`` / ``.get(...)`` call — the idiomatic
  get-or-create on a label-keyed dict.

Plain-name appends (``self.spans.append(...)``, a local ``hist`` list)
are not label-keyed aggregation and stay allowed.  The deliberate
exact-path sites (bounded by ``histogram_cap`` or by construction)
carry ``# repro: ignore[unbounded-telemetry]`` justifications.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.engine import Finding, SourceFile, \
    iter_findings_for_rule

RULE_ID = "unbounded-telemetry"

#: path fragment selecting the files under contract
TELEMETRY_DIR = "telemetry"

#: dict methods whose call result is a keyed, possibly-fresh container
_KEYED_GETTERS = {"setdefault", "get"}


def _is_keyed_receiver(recv: ast.AST) -> bool:
    if isinstance(recv, ast.Subscript):
        return True
    return (isinstance(recv, ast.Call)
            and isinstance(recv.func, ast.Attribute)
            and recv.func.attr in _KEYED_GETTERS)


def _hits(src: SourceFile) -> Iterator[tuple[int, str]]:
    for node in ast.walk(src.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"):
            continue
        recv = node.func.value
        if not _is_keyed_receiver(recv):
            continue
        shape = ("d[key].append(...)" if isinstance(recv, ast.Subscript)
                 else f"d.{recv.func.attr}(...).append(...)")
        yield (node.lineno,
               f"label-keyed list aggregation `{shape}` grows "
               f"unboundedly with label cardinality; route "
               f"high-cardinality series through a bounded "
               f"QuantileSketch/TopK (telemetry.sketch) or justify "
               f"the exact path with its bound")


def check(src: SourceFile) -> Iterator[Finding]:
    parts = src.relpath.split("/")
    if TELEMETRY_DIR not in parts[:-1]:
        return
    yield from iter_findings_for_rule(src, RULE_ID, _hits(src))
