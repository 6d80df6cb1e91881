"""unguarded-telemetry: telemetry must stay passive when disabled.

Two test-pinned properties depend on discipline at every call
site, and a single miss silently costs one of them:

* **bitwise invisibility** — a recording call on a telemetry session /
  trace sink / metrics registry that is not dominated by an
  ``if tel.enabled:`` test runs work on the disabled path;
* **allocation-freeness** — a module-level import of
  ``repro_torch.telemetry.learning`` materializes the diagnostics machinery
  even when telemetry is off (the tracemalloc guard only covers one
  path; this rule covers every import site).

The guard check applies to the orchestration layers (``orchestrator/``,
``train/``, ``topology/``, ``launch/``): a call whose receiver path
contains a ``tel``/``telemetry`` segment (``tel.span(...)``,
``sim.tel.flush()``, ``tel.health.evaluate(...)``) — or a
``registry``/``sink``/``trace`` segment with a *recording* method
(``counter``/``gauge``/``observe``/``span``/``instant``/...) — must sit
under a test mentioning ``.enabled``.  Recognized dominators: an
enclosing ``if <...>.enabled [and ...]:`` (the call in its body), the
guarded arm of a conditional expression, and an earlier
``if not <...>.enabled: return/raise/continue`` early exit in the same
block.  The always-live registry that backs ``RoundLog`` is unguarded
*by design* at a handful of sites — those carry explicit
``# repro: ignore[unguarded-telemetry]`` justifications.

The lazy-import check applies everywhere outside
``repro_torch/telemetry/learning.py`` itself.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, SourceFile

RULE_ID = "unguarded-telemetry"

#: directories whose files get the guard-domination check
GUARDED_DIRS = ("orchestrator", "train", "topology", "launch")

#: receiver segments that mark a telemetry object (any method guarded)
TEL_SEGMENTS = {"tel", "telemetry"}

#: receiver segments that mark a recorder only for recording methods
RECORDER_SEGMENTS = {"registry", "sink", "trace_sink", "tracer"}

RECORDING_METHODS = {
    "span", "instant", "counter", "gauge", "observe", "histogram",
    "record", "emit", "flush", "evaluate",
}

LEARNING_MODULE = "repro_torch.telemetry.learning"


def _mentions_enabled(expr: ast.AST) -> bool:
    for node in ast.walk(expr):
        if isinstance(node, ast.Attribute) and node.attr == "enabled":
            return True
        if isinstance(node, ast.Name) and node.id == "enabled":
            return True
    return False


def _is_not_enabled(expr: ast.AST) -> bool:
    return isinstance(expr, ast.UnaryOp) and \
        isinstance(expr.op, ast.Not) and _mentions_enabled(expr.operand)


def _body_exits(body: list) -> bool:
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _telemetry_call(node: ast.Call):
    """Return (receiver path, method) when the call targets a telemetry
    object, else None."""
    if not isinstance(node.func, ast.Attribute):
        return None
    method = node.func.attr
    recv = astutil.dotted_path(node.func.value)
    if recv is None:
        return None
    segs = set(recv.split("."))
    if segs & TEL_SEGMENTS:
        return recv, method
    if segs & RECORDER_SEGMENTS and method in RECORDING_METHODS:
        return recv, method
    return None


class _GuardScan:
    """Walk statement lists carrying a 'dominated by .enabled' flag."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def scan_stmts(self, stmts: list, guarded: bool) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # fresh scope: a guard outside a def does not dominate
                # calls made when the function runs later
                self.scan_stmts(stmt.body, False)
                continue
            if isinstance(stmt, ast.ClassDef):
                self.scan_stmts(stmt.body, guarded)
                continue
            if isinstance(stmt, ast.If):
                self.check_expr(stmt.test, guarded)
                pos = _mentions_enabled(stmt.test) and \
                    not _is_not_enabled(stmt.test)
                neg = _is_not_enabled(stmt.test)
                self.scan_stmts(stmt.body, guarded or pos)
                self.scan_stmts(stmt.orelse, guarded or neg)
                if neg and _body_exits(stmt.body):
                    guarded = True      # early-exit guard for the rest
                continue
            if isinstance(stmt, (ast.For, ast.While)):
                header = stmt.iter if isinstance(stmt, ast.For) \
                    else stmt.test
                self.check_expr(header, guarded)
                self.scan_stmts(stmt.body, guarded)
                self.scan_stmts(stmt.orelse, guarded)
                continue
            if isinstance(stmt, ast.With):
                for item in stmt.items:
                    self.check_expr(item.context_expr, guarded)
                self.scan_stmts(stmt.body, guarded)
                continue
            if isinstance(stmt, ast.Try):
                self.scan_stmts(stmt.body, guarded)
                for handler in stmt.handlers:
                    self.scan_stmts(handler.body, guarded)
                self.scan_stmts(stmt.orelse, guarded)
                self.scan_stmts(stmt.finalbody, guarded)
                continue
            self.check_expr(stmt, guarded)

    def check_expr(self, node: ast.AST, guarded: bool) -> None:
        if node is None or guarded:
            return
        parents = astutil.build_parents(node)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            hit = _telemetry_call(sub)
            if hit is None:
                continue
            if self._ifexp_guarded(sub, parents, node):
                continue
            recv, method = hit
            self.findings.append(Finding(
                file=self.src.relpath, line=sub.lineno, rule=RULE_ID,
                severity="error",
                message=(f"`{recv}.{method}(...)` is not dominated by an "
                         f"`if tel.enabled:` guard — disabled telemetry "
                         f"must stay bitwise-invisible (guard it, or "
                         f"justify an always-live registry write with an "
                         f"ignore)")))

    @staticmethod
    def _ifexp_guarded(call, parents, stop) -> bool:
        node = call
        while node is not stop:
            parent = parents.get(node)
            if parent is None:
                break
            if isinstance(parent, ast.IfExp) and node is parent.body \
                    and _mentions_enabled(parent.test):
                return True
            if isinstance(parent, ast.BoolOp) and \
                    isinstance(parent.op, ast.And) and \
                    parent.values and node in parent.values[1:] and \
                    _mentions_enabled(parent.values[0]):
                return True     # `tel.enabled and tel.span(...)`
            node = parent
        return False


def check(src: SourceFile) -> Iterator[Finding]:
    # lazy-import contract: applies to every scanned file
    if not src.relpath.endswith("telemetry/learning.py"):
        for node in ast.walk(src.tree):
            at_module_level = isinstance(node, (ast.Import,
                                                ast.ImportFrom)) and \
                node.col_offset == 0
            if not at_module_level:
                continue
            if isinstance(node, ast.Import):
                bad = any(a.name == LEARNING_MODULE for a in node.names)
            else:
                bad = node.module == LEARNING_MODULE or (
                    node.module == "repro_torch.telemetry" and
                    any(a.name == "learning" for a in node.names))
            if bad:
                yield Finding(
                    file=src.relpath, line=node.lineno, rule=RULE_ID,
                    severity="error",
                    message=("module-level import of "
                             "`repro_torch.telemetry.learning` defeats the "
                             "allocation-free disabled path — import it "
                             "lazily under `if tel.enabled:`"))

    parts = src.relpath.split("/")
    if not any(d in parts for d in GUARDED_DIRS):
        return
    scan = _GuardScan(src)
    scan.scan_stmts(src.tree.body, False)
    yield from scan.findings
