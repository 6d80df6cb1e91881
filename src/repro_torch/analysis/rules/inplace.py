"""read-after-inplace: a plain alias of a buffer that an in-place entry
mutates is not a snapshot.

The port's streaming AIO and training entries write into their operands
instead of returning fresh tensors (the TPU kernels alias their outputs
onto the accumulators; PyTorch updates the storage itself): ``aio_absorb``
/ ``aio_merge`` and their ``ops`` routes (arguments 0 and 1, on the CPU
route too), ``core/aggregation``'s ``absorb_trees`` / ``merge_trees``
(the planes, arguments 0 and 1) and ``partial_absorb`` /
``partial_merge`` (``.num`` and ``.den`` of argument 0),
``Optimizer.update(params, grads, state)`` (parameters and state), and
``core/distributed``'s ``anycost_gradient_sync``, ``anycost_sync_leaf``
and ``mean_gradient_sync`` (the gradient leaves; the error-feedback sync
returns new trees and is not listed).  A name bound as a plain alias of
such a path before the call (``old = num``, no ``.clone()``) and read
after it holds the new values, silently: under JAX the same code read
the old array.  This rule finds that read.

Tracking is path-based within one function scope, the reference's
``use-after-donate`` tracking: an assignment whose value is a dotted
path makes its target an alias of that path; an in-place call makes
every alias of a mutated path (or of a sub-path of it) stale, and an
alias of a parent object stale at the mutated sub-path; a later read of
a stale path (or a deeper attribute of it) before the alias is rebound
is a finding.  Rebinding the source path ends the aliasing.  Loop bodies
are analyzed twice, so an alias made in iteration *t* and read after the
call of iteration *t+1* is caught; branches are merged conservatively.
"""
from __future__ import annotations

import ast
from typing import Iterator, Optional

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, SourceFile

RULE_ID = "read-after-inplace"

#: callee last segment -> (((positional argnum, mutated-path suffix), ...),
#: the exact number of positional arguments the entry takes, or None)
INPLACE: dict[str, tuple[tuple[tuple[int, str], ...], Optional[int]]] = {
    "aio_absorb": (((0, ""), (1, "")), None),
    "aio_merge": (((0, ""), (1, "")), None),
    "aio_absorb_op": (((0, ""), (1, "")), None),
    "aio_merge_op": (((0, ""), (1, "")), None),
    "absorb_trees": (((0, ""), (1, "")), None),
    "merge_trees": (((0, ""), (1, "")), None),
    "partial_absorb": (((0, ".num"), (0, ".den")), None),
    "partial_merge": (((0, ".num"), (0, ".den")), None),
    # Optimizer.update(params, grads, state); three positional arguments
    # tell it from dict.update
    "update": (((0, ""), (2, "")), 3),
    "anycost_gradient_sync": (((0, ""),), None),
    "anycost_sync_leaf": (((0, ""),), None),
    "mean_gradient_sync": (((0, ""),), None),
}


def mutated_paths(call: ast.Call) -> list[str]:
    """The dotted paths an in-place entry call writes into."""
    callee = astutil.call_name(call)
    if callee is None:
        return []
    spec = INPLACE.get(astutil.last_segment(callee))
    if spec is None:
        return []
    positions, n_args = spec
    if n_args is not None and (len(call.args) != n_args or "." not in callee):
        return []
    out = []
    for argnum, suffix in positions:
        if argnum < len(call.args) and \
                not isinstance(call.args[argnum], ast.Starred):
            p = astutil.dotted_path(call.args[argnum])
            if p is not None:
                out.append(p + suffix)
    return out


def _exits(body: list) -> bool:
    return bool(body) and isinstance(
        body[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))


def _under(path: str, prefix: str) -> bool:
    return path == prefix or path.startswith(prefix + ".")


class _Env:
    """Aliases (alias path -> (source path, line)) and stale paths (path
    -> (alias, source, line of the call, callee))."""

    def __init__(self, aliases=None, stale=None):
        self.aliases: dict = dict(aliases or {})
        self.stale: dict = dict(stale or {})

    def copy(self) -> "_Env":
        return _Env(self.aliases, self.stale)

    def merge(self, *others: "_Env") -> "_Env":
        out = self.copy()
        for o in others:
            out.aliases.update(o.aliases)
            out.stale.update(o.stale)
        return out


class _Flow:
    def __init__(self):
        self.hits: set = set()

    def _reads(self, expr: ast.AST) -> Iterator[tuple[int, str]]:
        parents = astutil.build_parents(expr)
        for node in ast.walk(expr):
            if not isinstance(node, (ast.Name, ast.Attribute)):
                continue
            if not isinstance(getattr(node, "ctx", None), ast.Load):
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.Attribute) and parent.value is node:
                continue        # inner link of a longer chain
            p = astutil.dotted_path(node)
            if p is not None:
                yield node.lineno, p

    def check_reads(self, expr: Optional[ast.AST], env: _Env) -> None:
        if expr is None:
            return
        for line, path in self._reads(expr):
            for s, info in env.stale.items():
                if _under(path, s):
                    self.hits.add((line, path, *info))

    def activate(self, stmt: ast.AST, env: _Env) -> None:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            for mutated in mutated_paths(node):
                callee = astutil.last_segment(astutil.call_name(node))
                for alias, (source, _) in env.aliases.items():
                    info = (alias, mutated, node.lineno, callee)
                    if _under(source, mutated):
                        env.stale[alias] = info
                    elif _under(mutated, source):
                        env.stale[alias + mutated[len(source):]] = info

    @staticmethod
    def rebind(paths, env: _Env) -> None:
        for t in paths:
            for a in [a for a in env.aliases
                      if _under(a, t) or _under(env.aliases[a][0], t)]:
                del env.aliases[a]
            for s in [s for s in env.stale if _under(s, t)]:
                del env.stale[s]

    @staticmethod
    def bind_aliases(targets, value: ast.AST, line: int, env: _Env) -> None:
        pairs = []
        for target in targets:
            if isinstance(target, (ast.Tuple, ast.List)) and \
                    isinstance(value, (ast.Tuple, ast.List)) and \
                    len(target.elts) == len(value.elts):
                pairs.extend(zip(target.elts, value.elts))
            else:
                pairs.append((target, value))
        for target, val in pairs:
            t, v = astutil.dotted_path(target), astutil.dotted_path(val)
            if t is not None and v is not None and t != v:
                env.aliases[t] = (v, line)

    def block(self, stmts, env: _Env) -> _Env:
        for stmt in stmts:
            env = self.stmt(stmt, env)
        return env

    def _loop(self, stmt, env: _Env, *, header) -> _Env:
        self.check_reads(header, env)
        self.activate(header, env)
        if isinstance(stmt, ast.For):
            self.rebind(astutil.assigned_paths(stmt.target), env)
        env1 = self.block(stmt.body, env.copy())
        merged = env.merge(env1)
        env2 = self.block(stmt.body, merged.copy())
        return self.block(stmt.orelse, merged.merge(env2))

    def stmt(self, stmt: ast.AST, env: _Env) -> _Env:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return env          # a scope of its own
        if isinstance(stmt, ast.If):
            self.check_reads(stmt.test, env)
            self.activate(stmt.test, env)
            env_a = self.block(stmt.body, env.copy())
            env_b = self.block(stmt.orelse, env.copy())
            if _exits(stmt.body):
                env_a = _Env()
            if stmt.orelse and _exits(stmt.orelse):
                env_b = _Env()
            return env_a.merge(env_b)
        if isinstance(stmt, ast.For):
            return self._loop(stmt, env, header=stmt.iter)
        if isinstance(stmt, ast.While):
            return self._loop(stmt, env, header=stmt.test)
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self.check_reads(item.context_expr, env)
                if item.optional_vars is not None:
                    self.rebind(astutil.assigned_paths(item.optional_vars),
                                env)
            return self.block(stmt.body, env)
        if isinstance(stmt, ast.Try):
            env_b = self.block(stmt.body, env.copy())
            outs = [self.block(h.body, env_b.copy()) for h in stmt.handlers]
            merged = self.block(stmt.orelse, env_b.merge(*outs))
            return self.block(stmt.finalbody, merged)
        if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            self.check_reads(stmt.value, env)
            self.activate(stmt, env)
            if stmt.value is not None:
                for target in targets:
                    self.rebind(astutil.assigned_paths(target), env)
                self.bind_aliases(targets, stmt.value, stmt.lineno, env)
            return env
        if isinstance(stmt, ast.AugAssign):
            # x += e reads x, then writes it in place or rebinds it
            self.check_reads(stmt.value, env)
            p = astutil.dotted_path(stmt.target)
            if p is not None:
                for s, info in env.stale.items():
                    if _under(p, s):
                        self.hits.add((stmt.lineno, p, *info))
            self.activate(stmt, env)
            self.rebind(astutil.assigned_paths(stmt.target), env)
            return env
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                self.rebind(astutil.assigned_paths(target), env)
            return env
        self.check_reads(stmt, env)
        self.activate(stmt, env)
        return env


def check(src: SourceFile) -> Iterator[Finding]:
    scopes = [src.tree.body]
    scopes.extend(fn.body for fn in astutil.functions(src.tree))
    seen: set = set()
    for body in scopes:
        flow = _Flow()
        flow.block(body, _Env())
        for line, path, alias, mutated, cline, callee in sorted(flow.hits):
            if (line, path) in seen:
                continue
            seen.add((line, path))
            yield Finding(
                file=src.relpath, line=line, rule=RULE_ID,
                severity="error",
                message=(f"`{alias}` is a plain alias of `{mutated}`, "
                         f"which `{callee}` on line {cline} mutates in "
                         f"place; reading `{path}` after it sees the new "
                         f"values — take a `.clone()` before the call if "
                         f"the old ones are meant"))
