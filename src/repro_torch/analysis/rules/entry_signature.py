"""entry-signature: each ``build.Entry`` matches its C entry point.

A kernel wrapper calls its CUDA entry through ctypes: a module-level
``build.Entry(source, symbol, argtypes)`` in a ``kernels/`` module names
``extern "C" int <symbol>(...)`` in ``kernels/csrc/<source>.cu``, whose
last parameter, the ``cudaStream_t``, ``Entry.launch`` appends itself.
ctypes checks none of the rest, so a mismatch is silent memory
corruption.  This rule checks, in every scanned kernels module:

* the argtypes against the C parameters (less the stream), one for one
  by kind: a pointer <-> ``c_void_p``, ``int64_t`` <-> ``c_int64``,
  ``int`` <-> ``c_int``, ``int32_t`` <-> ``c_int32``, ``float`` <->
  ``c_float``, ``double`` <-> ``c_double``;
* every ``ENTRY.launch(index, ...)`` call passes that many arguments
  after the device index (a ``*name`` splat counts when ``name`` is
  bound to a tuple literal, or is a parameter that every call of the
  function in the module fills with one);
* every non-``const`` pointer receives ``t.data_ptr()`` of a tensor the
  wrapper allocated (``new_empty``, ``torch.empty*``) or of an operand
  that an entry of ``read-after-inplace``'s table mutates by contract
  (e.g. ``aio_absorb``'s ``num`` and ``den``); a tensor that arrived as
  a parameter is followed to every call of its function in the module;
* a ``const`` pointer never receives a fresh output (the kernel would
  read memory nobody wrote).
"""
from __future__ import annotations

import ast
import os
import re
from typing import Iterator, Optional

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, SourceFile
from repro_torch.analysis.rules import inplace
from repro_torch.analysis.rules.kernel_oracle import (entry_names,
                                                      is_kernels_module,
                                                      launch_calls)

RULE_ID = "entry-signature"

#: C scalar type -> the ctypes type that passes it
C_SCALARS = {"int64_t": "c_int64", "int": "c_int", "int32_t": "c_int32",
             "float": "c_float", "double": "c_double"}

#: calls whose result is a tensor the wrapper allocated
ALLOCATORS = {"new_empty", "empty", "empty_like", "empty_strided"}

_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def c_signatures(cu_text: str) -> dict[str, list[tuple[str, bool]]]:
    """symbol -> its parameters, each ``(kind, const)``: kind "pointer"
    or the C scalar type; the trailing ``cudaStream_t`` dropped."""
    text = re.sub(r"//[^\n]*|/\*.*?\*/", " ", cu_text, flags=re.S)
    out = {}
    for m in _EXTERN.finditer(text):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        if params and params[-1].split()[0] == "cudaStream_t":
            params = params[:-1]
        sig = []
        for p in params:
            if "*" in p:
                sig.append(("pointer", p.startswith("const")))
            else:
                sig.append((" ".join(p.split()[:-1]), False))
        out[m.group(1)] = sig
    return out


def _argtype_names(call: ast.Call) -> Optional[list[str]]:
    """The argtypes tuple of a ``build.Entry(...)`` call as ctypes names
    (``c_void_p``, ...), or None when it is not a literal tuple."""
    node = call.args[2] if len(call.args) > 2 else \
        astutil.keyword_arg(call, "argtypes")
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    names = []
    for elt in node.elts:
        p = astutil.dotted_path(elt)
        if p is None:
            return None
        names.append(astutil.last_segment(p))
    return names


def _str_arg(call: ast.Call, i: int, name: str) -> Optional[str]:
    node = call.args[i] if len(call.args) > i else \
        astutil.keyword_arg(call, name)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


class _Module:
    """One kernels module's functions and the calls between them."""

    def __init__(self, src: SourceFile):
        self.fns = {fn.name: fn for fn in src.tree.body
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef))}

    def call_sites(self, name: str) -> list[ast.Call]:
        return [node for fn in self.fns.values() for node in ast.walk(fn)
                if isinstance(node, ast.Call)
                and astutil.call_name(node) == name]

    def arg_at(self, call: ast.Call, fn: ast.FunctionDef,
               param: str) -> Optional[ast.AST]:
        params = astutil.param_names(fn)
        kw = astutil.keyword_arg(call, param)
        if kw is not None:
            return kw
        i = params.index(param)
        if i < len(call.args) and not any(isinstance(a, ast.Starred)
                                          for a in call.args[:i + 1]):
            return call.args[i]
        return None

    def enclosing(self, node: ast.AST) -> Optional[ast.FunctionDef]:
        for fn in self.fns.values():
            if any(n is node for n in ast.walk(fn)):
                return fn
        return None

    def status(self, fn: ast.FunctionDef, name: str, depth: int = 0
               ) -> set[str]:
        """What ``name`` holds in ``fn``: a set of "fresh" (allocated
        here), "inplace" (an operand an in-place entry mutates), "other"
        (a caller's tensor) — several when callers differ."""
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and any(
                    name in astutil.assigned_paths(t)
                    for t in node.targets):
                v = node.value
                if isinstance(v, ast.Call) and astutil.call_name(v) \
                        and astutil.last_segment(
                            astutil.call_name(v)) in ALLOCATORS:
                    return {"fresh"}
                return {"other"}
        if name not in astutil.param_names(fn):
            return {"other"}
        spec = inplace.INPLACE.get(fn.name)
        if spec is not None and any(
                suffix == "" and astutil.param_names(fn)[i] == name
                for i, suffix in spec[0]
                if i < len(astutil.param_names(fn))):
            return {"inplace"}
        sites = self.call_sites(fn.name)
        if not sites or depth > 4:
            return {"other"}
        out: set[str] = set()
        for call in sites:
            arg = self.arg_at(call, fn, name)
            caller = self.enclosing(call)
            if isinstance(arg, ast.Name) and caller is not None:
                out |= self.status(caller, arg.id, depth + 1)
            else:
                out.add("other")
        return out

    def splat_len(self, fn: Optional[ast.FunctionDef],
                  name: str) -> Optional[int]:
        """Length of the tuple a ``*name`` splat in ``fn`` expands."""
        if fn is None:
            return None
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id == name:
                return len(node.value.elts) if isinstance(
                    node.value, (ast.Tuple, ast.List)) else None
        if name not in astutil.param_names(fn):
            return None
        lens = set()
        for call in self.call_sites(fn.name):
            arg = self.arg_at(call, fn, name)
            lens.add(len(arg.elts) if isinstance(
                arg, (ast.Tuple, ast.List)) else None)
        return lens.pop() if len(lens) == 1 else None


def _f(src: SourceFile, line: int, message: str) -> Finding:
    return Finding(file=src.relpath, line=line, rule=RULE_ID,
                   severity="error", message=message)


def _check_launch(src: SourceFile, mod: _Module, call: ast.Call,
                  entry: str, symbol: str, sig: list) -> Iterator[Finding]:
    fn = mod.enclosing(call)
    args: list[Optional[ast.AST]] = []
    for a in call.args[1:]:
        if isinstance(a, ast.Starred):
            n = mod.splat_len(fn, a.value.id) \
                if isinstance(a.value, ast.Name) else None
            if n is None:
                yield _f(src, call.lineno,
                         f"`{entry}.launch` splats `*{ast.unparse(a.value)}`"
                         f", whose length cannot be resolved; pass "
                         f"`{symbol}`'s {len(sig)} arguments explicitly")
                return
            args.extend([None] * n)
        else:
            args.append(a)
    if len(args) != len(sig):
        yield _f(src, call.lineno,
                 f"`{entry}.launch` passes {len(args)} argument(s) after "
                 f"the device index; `{symbol}` takes {len(sig)} (less "
                 f"its stream)")
        return
    for i, (arg, (kind, const)) in enumerate(zip(args, sig)):
        if kind != "pointer" or arg is None:
            continue
        tensor = None
        if isinstance(arg, ast.Call) and isinstance(arg.func,
                                                    ast.Attribute) \
                and arg.func.attr == "data_ptr" \
                and isinstance(arg.func.value, ast.Name):
            tensor = arg.func.value.id
        if tensor is None:
            if not const:
                yield _f(src, call.lineno,
                         f"`{entry}.launch` argument {i} fills the "
                         f"non-const pointer {i} of `{symbol}` with "
                         f"`{ast.unparse(arg)}`, not a tensor's "
                         f"`data_ptr()`: the kernel writes through it")
            continue
        status = mod.status(fn, tensor) if fn is not None else {"other"}
        if const and "fresh" in status:
            yield _f(src, call.lineno,
                     f"`{entry}.launch` passes the fresh output "
                     f"`{tensor}` to the const pointer {i} of `{symbol}`:"
                     f" the kernel reads memory nobody wrote")
        elif not const and status - {"fresh", "inplace"}:
            yield _f(src, call.lineno,
                     f"`{entry}.launch` passes `{tensor}` to the non-const "
                     f"pointer {i} of `{symbol}`, which the kernel writes: "
                     f"neither a tensor the wrapper allocated nor an "
                     f"operand an in-place entry mutates by contract")


def check_project(files: list[SourceFile]) -> Iterator[Finding]:
    for src in files:
        if not is_kernels_module(src):
            continue
        entries = entry_names(src.tree)
        if not entries:
            continue
        mod = _Module(src)
        csrc = os.path.join(os.path.dirname(src.path), "csrc")
        sigs: dict[str, Optional[tuple]] = {}
        for name, call in entries.items():
            source = _str_arg(call, 0, "source")
            symbol = _str_arg(call, 1, "symbol")
            types = _argtype_names(call)
            if source is None or symbol is None or types is None:
                yield _f(src, call.lineno,
                         f"`{name}` is not `build.Entry(\"source\", "
                         f"\"symbol\", (ctypes types, ...))` with literals")
                sigs[name] = None
                continue
            cu = os.path.join(csrc, source + ".cu")
            if not os.path.exists(cu):
                yield _f(src, call.lineno,
                         f"`{name}` names csrc/{source}.cu, which does not "
                         f"exist")
                sigs[name] = None
                continue
            with open(cu, encoding="utf-8") as fh:
                found = c_signatures(fh.read()).get(symbol)
            if found is None:
                yield _f(src, call.lineno,
                         f"`{name}` names `{symbol}`, which csrc/{source}.cu"
                         f" does not define as `extern \"C\" int`")
                sigs[name] = None
                continue
            sigs[name] = (symbol, found)
            want = ["c_void_p" if kind == "pointer"
                    else C_SCALARS.get(kind, kind) for kind, _ in found]
            if types != want:
                yield _f(src, call.lineno,
                         f"`{name}`'s argtypes {tuple(types)} do not match "
                         f"`{symbol}`'s parameters {tuple(want)} (less its "
                         f"stream)")
                sigs[name] = None
        for fn in mod.fns.values():
            for call in launch_calls(fn, entries):
                got = sigs.get(call.func.value.id)
                if got is not None:
                    yield from _check_launch(src, mod, call,
                                             call.func.value.id, *got)
