"""Shared AST helpers for the rule pack: dotted paths, import aliases,
assignment targets and scope walking."""
from __future__ import annotations

import ast
from typing import Iterator, Optional


def dotted_path(node: ast.AST) -> Optional[str]:
    """``self.part.num`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_segment(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def call_name(call: ast.Call) -> Optional[str]:
    """Dotted path of the callee (``torch.rand``, ``ops.aio_absorb_op``,
    ...)."""
    return dotted_path(call.func)


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def module_aliases(tree: ast.Module) -> dict[str, str]:
    """local name -> module for plain imports (``np`` -> ``numpy``,
    ``torch`` -> ``torch``)."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    out[alias.asname] = alias.name
                else:
                    top = alias.name.split(".")[0]
                    out[top] = top
    return out


def from_imports(tree: ast.Module) -> dict[str, str]:
    """local name -> ``module.name`` for from-imports."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                out[alias.asname or alias.name] = \
                    f"{node.module}.{alias.name}"
    return out


def assigned_paths(target: ast.AST) -> Iterator[str]:
    """Dotted paths (re)bound by an assignment target (tuple / list
    unpacking and starred targets included)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            yield from assigned_paths(elt)
    elif isinstance(target, ast.Starred):
        yield from assigned_paths(target.value)
    else:
        p = dotted_path(target)
        if p is not None:
            yield p


def build_parents(tree: ast.AST) -> dict[ast.AST, ast.AST]:
    parents: dict[ast.AST, ast.AST] = {}
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            parents[child] = node
    return parents


def functions(tree: ast.AST) -> Iterator[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def param_names(fn: ast.FunctionDef) -> list[str]:
    args = fn.args
    return [a.arg for a in (*args.posonlyargs, *args.args)]
