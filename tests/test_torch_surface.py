"""The port covers the reference's public surface: read from the sources
by ``ast`` alone, with neither package imported.

For every module of ``src/repro/`` the public surface is: the top-level
``def``s and classes whose names do not start with ``_``, the upper-case
constants, and the names it re-exports (imported from inside the
package in an ``__init__.py``, listed in ``__all__``, or imported under
``# noqa: F401``); and of each public class, its public methods and
properties, its dataclass fields and class attributes (of a private
class too, where the port has it: ``_NullTelemetry`` stands behind the
public ``NULL_TELEMETRY``).  Each must be
bound in the port's module of the same path (by a definition or an
import), or stand in ``NO_COUNTERPART`` with its reason.  An entry of
that table that the port does have, or that ROADMAP.md §3 does not
state, fails too.

The parameter names of each function and method defined in both are
compared under the port's stated renames: a JAX ``key`` becomes a
``rand`` / generator argument (``rand``, ``gen``, ``draw``); the
``use_kernel`` / ``use_pallas`` switches go (a wrapper dispatches by the
tensor's device); the Pallas ``interpret`` flag and block sizes go; the
jitted fast paths' ``fast`` goes; ``jax_profile`` is ``torch_profile``.
Every parameter of the reference's must then be a parameter of the
port's (the port may add its own, such as ``device``), but for the
differences ``PARAM_DIFFERENCES`` lists with their reasons.
"""
import ast
import os
import re

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
REF = os.path.join(ROOT, "src", "repro")
PORT = os.path.join(ROOT, "src", "repro_torch")

CONST = re.compile(r"^[A-Z][A-Z0-9_]*$")
KEY_NAMES = {"key", "rand", "gen", "draw"}
DROPPED = {
    "use_kernel", "use_pallas",   # dispatch by the tensor's device
    "interpret",                  # Pallas interpret mode
    "bk", "bc", "block_n",        # Pallas block sizes
    "fast",                       # the jitted fast paths
}
RENAMED = {"jax_profile": "torch_profile"}

# (module, name) -> why the port has no counterpart; name None: the module
NO_COUNTERPART = {
    ("utils/compat.py", None): "JAX version shims",
    ("analysis/rules/donation.py", None):
        "JAX buffer donation; the port's `inplace` rule restates it",
    ("analysis/rules/io_alias.py", None):
        "JAX input/output aliasing; the port's `entry_signature` rule "
        "restates it",
    ("analysis/rules/__init__.py", "donation"): "the donation rule above",
    ("analysis/rules/__init__.py", "io_alias"): "the io_alias rule above",
    ("analysis/astutil.py", "const_int_tuple"): "a donation-rule helper",
    ("analysis/astutil.py", "donated_argnums"): "a donation-rule helper",
    ("analysis/astutil.py", "jit_assignment_donations"):
        "a donation-rule helper",
    ("kernels/aio_agg.py", "BN"): "a Pallas block size",
    ("kernels/quantize.py", "BN"): "a Pallas block size",
    ("kernels/sparsify.py", "BK"): "a Pallas block size",
    ("kernels/sparsify.py", "BC"): "a Pallas block size",
    ("kernels/fused_compress.py", "BK"): "a Pallas block size",
    ("kernels/fused_compress.py", "BC"): "a Pallas block size",
    ("kernels/ops.py", "interpret_default"): "the Pallas interpret switch",
    ("kernels/fused_compress.py", "fused_ref"):
        "the port's is kernels/ref.fused_sparsify_quantize_ref",
    ("launch/roofline.py", "PEAK_FLOPS"):
        "a TPU constant; the port's are H100_PEAK_FLOPS and the like",
    ("launch/roofline.py", "HBM_BW"): "a TPU constant",
    ("launch/roofline.py", "ICI_BW"): "a TPU constant",
    ("launch/roofline.py", "COLLECTIVE_OPS"):
        "HLO op names; the port records collectives as they run",
    ("launch/roofline.py", "parse_collectives"): "parses HLO text",
    ("launch/roofline.py", "parse_collectives_flat"): "parses HLO text",
    ("launch/roofline.py", "collective_histogram"): "parses HLO text",
    ("models/cnn.py", "maxpool"): "F.max_pool2d",
    ("core/anycost.py", "AnycostClient.finish_from_parts"):
        "a jitted fast path",
    ("core/anycost.py", "AnycostClient.finish_round_fast"):
        "a jitted fast path",
    ("orchestrator/runner.py", "Simulation.shrink_fast"):
        "a jitted fast path",
}

# (module, function) -> why its parameters differ beyond the renames
PARAM_DIFFERENCES = {
    ("topology/edge.py", "finalize_apply"):
        "takes the PartialAgg `part` whole, not its `num` and `den`",
    ("models/cnn.py", "apply_cnn"):
        "no `cfg`: the reference's is unused (the tree's keys decide)",
    ("orchestrator/client_pool.py", "ClientPool.train_shared"):
        "no `subs`: it shrinks once per width bucket and sets each job's "
        "`sub_params`",
    ("models/transformer.py", "scan_blocks"):
        "no `unroll`: a Python loop over the stacked layers, not lax.scan",
    ("train/baselines.py", "stc_compress"):
        "no `key`: STC draws nothing (the reference deletes its key)",
}


def _modules():
    out = []
    for root, _, files in os.walk(REF):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), REF)
                           .replace(os.sep, "/"))
    return sorted(out)


MODULES = _modules()
GROUPS = sorted({m.split("/")[0] for m in MODULES})


def _statements(body):
    """Top-level statements, through ``if`` and ``try`` blocks."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _statements(node.body)
            yield from _statements(node.orelse)
        elif isinstance(node, ast.Try):
            yield from _statements(node.body)
            for h in node.handlers:
                yield from _statements(h.body)
            yield from _statements(node.orelse)
            yield from _statements(node.finalbody)
        else:
            yield node


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
    return names


def _members(cls: ast.ClassDef, public: bool) -> dict:
    """Methods (name -> parameters) and fields (name -> None)."""
    out = {}
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name == "__init__" or not node.name.startswith("_"):
                out[node.name] = _params(node)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out[node.target.id] = None
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = None
    if public:
        out = {k: v for k, v in out.items()
               if k == "__init__" or not k.startswith("_")}
    return out


class Module:
    """One source file's top-level bindings, read by ``ast``."""

    def __init__(self, path: str, pkg: str):
        self.path = path
        src = open(path).read()
        lines = src.splitlines()
        tree = ast.parse(src)
        self.defs = {}        # name -> parameters
        self.classes = {}     # name -> ClassDef node
        self.bound = set()    # every top-level name
        self.public = set()   # the reference's notion of public
        self.imports = {}     # name -> (module, original name)
        all_names = set()
        is_init = path.endswith("__init__.py")
        for node in _statements(tree.body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = _params(node)
                self.bound.add(node.name)
                if not node.name.startswith("_"):
                    self.public.add(node.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node
                self.bound.add(node.name)
                if not node.name.startswith("_"):
                    self.public.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    for e in ([t] if isinstance(t, ast.Name)
                              else getattr(t, "elts", [])):
                        if not isinstance(e, ast.Name):
                            continue
                        self.bound.add(e.id)
                        if CONST.match(e.id):
                            self.public.add(e.id)
                        if e.id == "__all__":
                            all_names = {c.value for c in node.value.elts}
            elif isinstance(node, ast.Import):
                for a in node.names:
                    self.bound.add(a.asname or a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom):
                inside = node.level > 0 or \
                    (node.module or "").split(".")[0] == pkg
                noqa = "noqa: F401" in "\n".join(
                    lines[node.lineno - 1:node.end_lineno])
                for a in node.names:
                    name = a.asname or a.name
                    self.bound.add(name)
                    if inside and node.module:
                        self.imports[name] = (node.module, a.name)
                    if inside and not name.startswith("_") and (
                            is_init or noqa or name in all_names):
                        self.public.add(name)
        self.public |= all_names


_CACHE = {}


def _module(path: str, pkg: str):
    if path not in _CACHE:
        _CACHE[path] = Module(path, pkg) if os.path.exists(path) else None
    return _CACHE[path]


def _source(dotted: str):
    base = os.path.join(ROOT, "src", *dotted.split("."))
    for path in (base + ".py", os.path.join(base, "__init__.py")):
        if os.path.exists(path):
            return path
    return None


def _port_def(mod: Module, name: str, depth: int = 3):
    """The parameters of ``name`` in a port module, through its imports."""
    if name in mod.defs:
        return mod.defs[name]
    if name in mod.imports and depth:
        src = _source(mod.imports[name][0])
        if src is not None:
            return _port_def(_module(src, "repro_torch"),
                             mod.imports[name][1], depth - 1)
    return None


def _port_class(mod: Module, name: str, depth: int = 3):
    if name in mod.classes:
        return mod.classes[name]
    if name in mod.imports and depth:
        src = _source(mod.imports[name][0])
        if src is not None:
            return _port_class(_module(src, "repro_torch"),
                               mod.imports[name][1], depth - 1)
    return None


def _canon(name: str):
    if name in DROPPED:
        return None
    if name in KEY_NAMES:
        return "key"
    return RENAMED.get(name, name)


def missing_names(group: str) -> list:
    """(module, name) of the reference's surface with no port binding."""
    out = []
    for rel in MODULES:
        if rel.split("/")[0] != group:
            continue
        ref = _module(os.path.join(REF, rel), "repro")
        port = _module(os.path.join(PORT, rel), "repro_torch")
        if port is None:
            out.append((rel, None))
            continue
        for name in sorted(ref.public - port.bound):
            out.append((rel, name))
        for cname in sorted(ref.classes):
            pcls = _port_class(port, cname)
            if pcls is None:
                continue
            have = set(_members(pcls, public=False))
            for m in sorted(_members(ref.classes[cname], public=True)):
                if RENAMED.get(m, m) not in have and not (
                        m in KEY_NAMES and KEY_NAMES & have):
                    out.append((rel, f"{cname}.{m}"))
    return out


def param_differences(group: str) -> list:
    """(module, function, missing parameters) under the renames."""
    pairs = []
    for rel in MODULES:
        if rel.split("/")[0] != group:
            continue
        ref = _module(os.path.join(REF, rel), "repro")
        port = _module(os.path.join(PORT, rel), "repro_torch")
        if port is None:
            continue
        for name in sorted(ref.public & set(ref.defs)):
            pairs.append((rel, name, ref.defs[name], _port_def(port, name)))
        for cname in sorted(ref.classes):
            pcls = _port_class(port, cname)
            if pcls is None:
                continue
            have = _members(pcls, public=False)
            for m, params in _members(ref.classes[cname],
                                      public=True).items():
                if params is not None and have.get(m) is not None:
                    pairs.append((rel, f"{cname}.{m}", params, have[m]))
    out = []
    for rel, name, want, got in pairs:
        if got is None:
            continue
        lost = [p for p in want if _canon(p) is not None
                and _canon(p) not in {_canon(q) for q in got}]
        if lost:
            out.append((rel, name, lost))
    return out


@pytest.mark.parametrize("group", GROUPS)
def test_every_public_name_has_a_counterpart(group):
    missing = [m for m in missing_names(group) if m not in NO_COUNTERPART]
    assert not missing, f"public names of repro with no counterpart in " \
        f"repro_torch (port them, or list them with a reason): {missing}"


@pytest.mark.parametrize("group", GROUPS)
def test_parameter_names_match_under_the_renames(group):
    diff = [d for d in param_differences(group)
            if d[:2] not in PARAM_DIFFERENCES]
    assert not diff, f"reference parameters the port lacks: {diff}"


def test_every_exception_is_still_needed():
    """A table entry that the port now has is stale."""
    missing = {m for g in GROUPS for m in missing_names(g)}
    assert set(NO_COUNTERPART) <= missing, \
        sorted(set(NO_COUNTERPART) - missing)
    differ = {d[:2] for g in GROUPS for d in param_differences(g)}
    assert set(PARAM_DIFFERENCES) <= differ, \
        sorted(set(PARAM_DIFFERENCES) - differ)


def test_every_exception_is_stated_in_the_roadmap():
    """Each table entry's module or name stands in ROADMAP.md §3."""
    text = open(os.path.join(ROOT, "ROADMAP.md")).read()
    start = text.index("### 3.")
    section = text[start:text.index("\n## ", start)]
    unstated = []
    for rel, name in list(NO_COUNTERPART) + list(PARAM_DIFFERENCES):
        token = re.escape(rel if name is None else name.split(".")[-1])
        # in backticks, alone or as the last part of a dotted path
        if not re.search(rf"`(?:[^`\s]*[./])?{token}(?:\(|`)", section):
            unstated.append((rel, name))
    assert not unstated, unstated


def test_the_walk_sees_the_surface():
    """The AST walk finds what it should: a def, a constant, a
    dataclass field, a property, an ``__init__`` re-export, a ``noqa``
    re-export, a class method's parameters."""
    ref = _module(os.path.join(REF, "utils/pytree.py"), "repro")
    assert {"tree_dot", "named_leaves", "map_named"} <= ref.public
    hb = _module(os.path.join(REF, "topology/backhaul.py"), "repro")
    members = _members(hb.classes["BackhaulConfig"], public=True)
    assert {"payload_factor", "wire_factor", "ship_cost"} <= set(members)
    assert members["ship_cost"] == ["self", "s_bits"]
    orch = _module(os.path.join(REF, "orchestrator/__init__.py"), "repro")
    assert {"run_orchestrated", "OrchestratorConfig"} <= orch.public
    fl = _module(os.path.join(REF, "train/fl_loop.py"), "repro")
    assert {"AnycostClient", "METHODS", "FLRunConfig"} <= fl.public
    assert "np" not in fl.public and "jnp" not in fl.public
    assert len(MODULES) > 90 and "kernels" in GROUPS
