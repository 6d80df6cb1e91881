"""kernel-oracle-pairing: every exported CUDA kernel has a contract.

The port's kernels are held against plain PyTorch versions: each
wrapper in ``kernels/`` that launches a hand-written CUDA entry has a
plain version in ``kernels/ref.py``, which the CPU route runs and the
card tests compare the kernel with.  A kernel without a registered
plain version, or without a card test, ships on trust.  This rule closes
the loop statically:

* an *exported kernel* is a public module-level function in a
  ``kernels/`` module (other than ``ref.py``, ``ops.py``, ``build.py``
  and ``__init__.py``) that calls ``.launch(`` on a module-level
  ``build.Entry``, or publicly wraps (through the module's own
  functions, any depth) one that does;
* every exported kernel must be a key of the ``ORACLES`` table in the
  sibling ``kernels/ref.py`` or have a ``<kernel>_ref`` function there;
* when the scanned file set includes test files (``test_*.py``), every
  exported kernel must be named in at least one test file marked
  ``gpu`` (``pytestmark = pytest.mark.gpu`` or a ``@pytest.mark.gpu``
  decorator) — so CLI runs over ``src/repro_torch`` alone still check
  the pairing, and runs over ``tests`` too check the coverage.
"""
from __future__ import annotations

import ast
import os
from typing import Iterator

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, SourceFile

RULE_ID = "kernel-oracle-pairing"

NON_KERNEL_FILES = {"ref.py", "ops.py", "build.py", "__init__.py"}


def is_kernels_module(src: SourceFile) -> bool:
    parts = src.relpath.split("/")
    return "kernels" in parts[:-1] and parts[-1] not in NON_KERNEL_FILES


def kernels_dir(src: SourceFile) -> str:
    dirs = src.relpath.split("/")[:-1]
    idx = len(dirs) - 1 - dirs[::-1].index("kernels")
    return "/".join(dirs[:idx + 1])


def entry_names(tree: ast.Module) -> dict[str, ast.Call]:
    """Module-level ``NAME = build.Entry(...)`` bindings: name -> call."""
    out: dict[str, ast.Call] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            callee = astutil.call_name(node.value)
            if callee is not None \
                    and astutil.last_segment(callee) == "Entry":
                out[node.targets[0].id] = node.value
    return out


def launch_calls(fn: ast.AST, entries: dict) -> Iterator[ast.Call]:
    """``ENTRY.launch(...)`` calls in ``fn`` on a module-level entry."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "launch" \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in entries:
            yield node


def exported_kernels(src: SourceFile) -> list[tuple[str, int]]:
    """Public functions that launch an entry, directly or through the
    module's own functions."""
    entries = entry_names(src.tree)
    fns = {fn.name: fn for fn in src.tree.body
           if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))}
    launching = {name for name, fn in fns.items()
                 if any(True for _ in launch_calls(fn, entries))}
    calls = {name: {astutil.last_segment(c) for c in
                    (astutil.call_name(n) for n in ast.walk(fn)
                     if isinstance(n, ast.Call)) if c is not None}
             for name, fn in fns.items()}
    changed = True
    while changed:
        changed = False
        for name in fns:
            if name not in launching and calls[name] & launching:
                launching.add(name)
                changed = True
    return sorted((name, fns[name].lineno) for name in launching
                  if not name.startswith("_"))


def _oracle_names(ref_src: SourceFile) -> set[str]:
    """Keys of the ORACLES table plus ``<name>_ref`` function stems."""
    names: set[str] = set()
    for node in ref_src.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name) and \
                node.targets[0].id == "ORACLES" and \
                isinstance(node.value, ast.Dict):
            for k in node.value.keys:
                if isinstance(k, ast.Constant) and isinstance(k.value,
                                                              str):
                    names.add(k.value)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name.endswith("_ref"):
            names.add(node.name[:-len("_ref")])
    return names


def _marked_gpu(tree: ast.Module) -> bool:
    """A ``pytest.mark.gpu`` anywhere in the file (module mark or a
    decorator)."""
    return any(isinstance(node, ast.Attribute) and node.attr == "gpu"
               and astutil.dotted_path(node.value) in ("pytest.mark",
                                                       "mark")
               for node in ast.walk(tree))


def _gpu_test_refs(files: list[SourceFile]) -> tuple[bool, set[str]]:
    """(any test files present, names referenced in a test file marked
    ``gpu``)."""
    any_tests = False
    referenced: set[str] = set()
    for src in files:
        if not os.path.basename(src.relpath).startswith("test_"):
            continue
        any_tests = True
        if not _marked_gpu(src.tree):
            continue
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Name):
                referenced.add(node.id)
            elif isinstance(node, ast.Attribute):
                referenced.add(node.attr)
    return any_tests, referenced


def check_project(files: list[SourceFile]) -> Iterator[Finding]:
    kernel_mods = [s for s in files if is_kernels_module(s)]
    if not kernel_mods:
        return
    refs_by_dir = {kernels_dir(s): s for s in files
                   if s.relpath.endswith("/ref.py")
                   and "kernels" in s.relpath.split("/")}
    any_tests, tested = _gpu_test_refs(files)
    for src in kernel_mods:
        kernels = exported_kernels(src)
        if not kernels:
            continue
        ref_src = refs_by_dir.get(kernels_dir(src))
        oracles = _oracle_names(ref_src) if ref_src is not None else set()
        for name, line in kernels:
            if ref_src is None:
                yield Finding(
                    file=src.relpath, line=line, rule=RULE_ID,
                    severity="error",
                    message=(f"kernel `{name}` has no sibling "
                             f"kernels/ref.py — every CUDA kernel needs "
                             f"a plain PyTorch version"))
            elif name not in oracles:
                yield Finding(
                    file=src.relpath, line=line, rule=RULE_ID,
                    severity="error",
                    message=(f"kernel `{name}` is not registered in "
                             f"kernels/ref.py (add an ORACLES entry or "
                             f"a `{name}_ref` plain version)"))
            if any_tests and name not in tested:
                yield Finding(
                    file=src.relpath, line=line, rule=RULE_ID,
                    severity="error",
                    message=(f"kernel `{name}` is never named in a test "
                             f"file marked `gpu` among the scanned "
                             f"test files"))
