"""Analysis engine: file walker, parsed-source model, rule runner (the
reference checker's, ``repro/analysis/engine.py``, for the port's rules).

A rule is a callable registered in :mod:`repro_torch.analysis.rules`;
per-file rules see one :class:`SourceFile` at a time, project rules see
the whole scanned file set (needed for cross-file contracts like the
kernel/oracle pairing and the C entry signatures).  The engine owns
everything rule-agnostic: walking the paths, parsing, per-line
``# repro: ignore[rule-id]`` suppressions, and turning rule output into a
stable, sorted :class:`Finding` list.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Iterator, Optional

#: ``# repro: ignore[rule-a, rule-b]`` — the per-line escape hatch.
_IGNORE_RE = re.compile(r"#\s*repro:\s*ignore\[([A-Za-z0-9_\-, ]+)\]")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation, anchored to a file/line.

    ``file`` is stored relative to the invocation root so baselines and
    reports are stable across checkouts.
    """
    file: str
    line: int
    rule: str
    severity: str
    message: str

    def key(self) -> tuple:
        """Baseline identity: deliberately excludes the line number so
        unrelated edits shifting code up/down do not churn the baseline."""
        return (self.file, self.rule, self.message)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SourceFile:
    """A parsed Python source file plus its suppression map."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.Module] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            self.parse_error = e
        self._suppressed = _suppression_map(self.lines)

    def is_suppressed(self, line: int, rule: str) -> bool:
        """True if ``line`` — or the contiguous block of comment-only
        lines directly above it (a multi-line justification) — carries
        ``# repro: ignore[...]`` naming ``rule``."""
        def names(cand: int) -> bool:
            ids = self._suppressed.get(cand)
            return ids is not None and (rule in ids or "*" in ids)

        if names(line):
            return True
        cand = line - 1
        while self._comment_only(cand):
            if names(cand):
                return True
            cand -= 1
        return False

    def _comment_only(self, line: int) -> bool:
        if not 1 <= line <= len(self.lines):
            return False
        return self.lines[line - 1].lstrip().startswith("#")


def _suppression_map(lines: list[str]) -> dict[int, set[str]]:
    out: dict[int, set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _IGNORE_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
    return out


#: path fragments never scanned when walking directories: the analysis
#: test corpora (``fixtures/analysis`` and ``fixtures/analysis_torch``)
#: are deliberately full of violations
DEFAULT_EXCLUDES = ("fixtures/analysis",)


def collect_files(paths: Iterable[str], root: Optional[str] = None,
                  excludes: tuple[str, ...] = DEFAULT_EXCLUDES
                  ) -> list[SourceFile]:
    """Expand files/directories into parsed :class:`SourceFile`\\ s.

    Directories are walked recursively for ``*.py``; hidden directories,
    ``__pycache__``, and paths containing an ``excludes`` fragment are
    skipped (explicitly-listed files are always taken — that is how the
    fixture tests drive the engine over the corpus).  ``root`` (default:
    cwd) anchors the relative paths used in findings and baselines.
    """
    root = os.path.abspath(root or os.getcwd())
    seen: set[str] = set()
    out: list[SourceFile] = []

    def add(fp: str, *, walked: bool = False) -> None:
        fp = os.path.abspath(fp)
        if fp in seen or not fp.endswith(".py"):
            return
        if walked and any(frag in fp.replace(os.sep, "/")
                          for frag in excludes):
            return
        seen.add(fp)
        with open(fp, encoding="utf-8") as fh:
            text = fh.read()
        rel = os.path.relpath(fp, root)
        out.append(SourceFile(fp, rel.replace(os.sep, "/"), text))

    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if not d.startswith(".")
                                     and d != "__pycache__")
                for fn in sorted(filenames):
                    add(os.path.join(dirpath, fn), walked=True)
        else:
            add(p)
    out.sort(key=lambda s: s.relpath)
    return out


def run_analysis(paths: Iterable[str], rules=None,
                 root: Optional[str] = None) -> list[Finding]:
    """Run ``rules`` (default: the full registry) over ``paths``.

    Returns suppression-filtered findings sorted by (file, line, rule).
    A file that fails to parse yields a single ``parse-error`` finding
    instead of crashing the run.
    """
    from repro_torch.analysis.rules import ALL_RULES
    rules = list(ALL_RULES if rules is None else rules)
    files = collect_files(paths, root=root)
    findings: list[Finding] = []
    for src in files:
        if src.parse_error is not None:
            findings.append(Finding(
                file=src.relpath, line=src.parse_error.lineno or 1,
                rule="parse-error", severity="error",
                message=f"syntax error: {src.parse_error.msg}"))
    for rule in rules:
        if rule.scope == "file":
            for src in files:
                if src.tree is not None:
                    findings.extend(rule.check(src))
        else:
            findings.extend(
                rule.check_project([s for s in files if s.tree is not None]))
    kept = []
    by_path = {s.relpath: s for s in files}
    for f in findings:
        src = by_path.get(f.file)
        if src is not None and src.is_suppressed(f.line, f.rule):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.file, f.line, f.rule, f.message))
    return kept


def iter_findings_for_rule(src: SourceFile, rule_id: str,
                           hits: Iterator[tuple[int, str]],
                           severity: str = "error") -> Iterator[Finding]:
    """Helper for rules: wrap (line, message) pairs into Findings."""
    for line, message in hits:
        yield Finding(file=src.relpath, line=line, rule=rule_id,
                      severity=severity, message=message)
