"""unseeded-randomness: every stochastic draw must replay.

The port's ground rule "Randomness is an input": every random value
flows from a seeded stream — a ``torch.Generator`` passed as
``generator=``, or ``np.random.default_rng([seed, stream, i])`` on the
host — so that seeded runs replay and parity tests can feed the
reference's draws.  The ways code breaks that, all caught here:

* torch's global RNG: ``torch.rand/randn/randint/randperm``, their
  ``*_like`` forms, ``torch.bernoulli/multinomial/normal/poisson`` and
  the in-place ``.uniform_/.normal_/.bernoulli_/.random_/.exponential_``
  called without ``generator=``; and reseeding it, ``torch.manual_seed``,
  ``torch.seed`` and ``torch.cuda.manual_seed*``;
* module-level numpy RNG state: any ``np.random.<fn>(...)`` call other
  than ``default_rng`` (``np.random.rand``, ``np.random.seed``, ...),
  and ``default_rng()`` called with *no* seed (OS-entropy seeded);
* the stdlib ``random`` module: one process-global Mersenne Twister —
  any ``random.<fn>(...)`` call, and unseeded ``random.Random()``;
* wall-clock reads — ``time.time()`` / ``time.time_ns()`` /
  ``time.monotonic()`` / ``time.perf_counter()`` / ``datetime.now()`` /
  ``datetime.utcnow()``: values that differ per run.  The telemetry
  package is exempt (timestamps are its job and are excluded from trace
  signatures); everywhere else, wall-clock progress reporting needs an
  explicit ``# repro: ignore[unseeded-randomness]`` stating why the
  value never feeds simulation state.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis import astutil
from repro_torch.analysis.engine import Finding, SourceFile

RULE_ID = "unseeded-randomness"

#: path fragments whose files may read wall clocks (telemetry timestamps)
WALLCLOCK_EXEMPT = ("/telemetry/",)

_WALLCLOCK = {
    ("time", "time"), ("time", "time_ns"), ("time", "monotonic"),
    ("time", "monotonic_ns"), ("time", "perf_counter"),
    ("time", "perf_counter_ns"),
    ("datetime", "now"), ("datetime", "utcnow"), ("datetime", "today"),
    ("date", "today"),
}

#: torch functions that draw from the global generator unless given one
TORCH_DRAWS = {
    "rand", "randn", "randint", "randperm", "rand_like", "randn_like",
    "randint_like", "bernoulli", "multinomial", "normal", "poisson",
}

#: tensor methods that fill in place from the global generator unless
#: given one
INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                 "exponential_"}

#: calls that reseed torch's global generators
TORCH_RESEEDS = {"torch.manual_seed", "torch.seed",
                 "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                 "torch.cuda.seed", "torch.cuda.seed_all"}


def _torch_path(path: str, aliases: dict, froms: dict) -> str:
    """``path`` with its first segment resolved through the imports
    (``th.rand`` -> ``torch.rand``; a from-imported ``rand`` ->
    ``torch.rand``)."""
    head, _, rest = path.partition(".")
    if head in aliases:
        base = aliases[head]
    elif head in froms:
        base = froms[head]
    else:
        return path
    return f"{base}.{rest}" if rest else base


def _torch_hit(node: ast.Call, path: str, aliases: dict,
               froms: dict) -> str | None:
    """The message for a draw from (or a reseed of) torch's global
    generator, else None."""
    full = _torch_path(path, aliases, froms)
    if full in TORCH_RESEEDS:
        return (f"`{path}(...)` reseeds torch's global generator; build a "
                f"`torch.Generator().manual_seed(...)` and pass it as "
                f"`generator=`")
    segs = full.split(".")
    if len(segs) == 2 and segs[0] == "torch" and segs[1] in TORCH_DRAWS \
            and astutil.keyword_arg(node, "generator") is None:
        return (f"`{path}(...)` draws from torch's global generator; pass "
                f"a seeded `generator=`")
    return None


def check(src: SourceFile) -> Iterator[Finding]:
    aliases = astutil.module_aliases(src.tree)
    froms = astutil.from_imports(src.tree)
    wallclock_ok = any(frag in "/" + src.relpath
                       for frag in WALLCLOCK_EXEMPT)
    numpy_names = {n for n, mod in aliases.items()
                   if mod in ("numpy", "numpy.random")}
    has_std_random = any(mod == "random" for mod in aliases.values())

    for node in ast.walk(src.tree):
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in INPLACE_DRAWS \
                and astutil.keyword_arg(node, "generator") is None:
            yield _f(src, node,
                     f"`.{node.func.attr}(...)` fills from torch's global "
                     f"generator; pass a seeded `generator=`")
            continue
        path = astutil.call_name(node)
        if path is None:
            continue
        segs = path.split(".")

        # --- torch's global generator ---------------------------------
        msg = _torch_hit(node, path, aliases, froms)
        if msg is not None:
            yield _f(src, node, msg)
            continue

        # --- numpy module-level RNG -----------------------------------
        if len(segs) >= 3 and segs[0] in numpy_names \
                and segs[-2] == "random" and segs[-1] != "default_rng" \
                and segs[-1][:1].islower():
            yield _f(src, node,
                     f"`{path}(...)` uses numpy's module-level RNG "
                     f"state; draw from a seeded "
                     f"`np.random.default_rng([seed, stream])` instead")
            continue
        if segs[-1] == "default_rng" and not node.args and \
                not node.keywords:
            looks_numpy = (len(segs) == 1 and
                           froms.get(path, "").endswith(
                               "random.default_rng")) or \
                          (len(segs) >= 2 and segs[-2] == "random")
            if looks_numpy:
                yield _f(src, node,
                         "`default_rng()` with no seed draws from OS "
                         "entropy; pass `[seed, stream]` so the run "
                         "replays")
                continue

        # --- stdlib random --------------------------------------------
        if len(segs) == 2 and segs[0] == "random" and has_std_random \
                and aliases.get("random") == "random":
            if segs[1] == "Random" and not node.args:
                yield _f(src, node,
                         "unseeded `random.Random()`; pass an explicit "
                         "seed derived from the run config")
            elif segs[1][:1].islower():
                yield _f(src, node,
                         f"`{path}(...)` uses the process-global stdlib "
                         f"RNG; use a seeded "
                         f"`np.random.default_rng([...])` stream")
            continue
        if len(segs) == 1 and froms.get(path, "").startswith("random."):
            yield _f(src, node,
                     f"`{path}(...)` (from the stdlib `random` module) "
                     f"uses process-global RNG state; use a seeded "
                     f"`np.random.default_rng([...])` stream")
            continue

        # --- wall clock -----------------------------------------------
        if wallclock_ok:
            continue
        if len(segs) >= 2 and (segs[-2], segs[-1]) in _WALLCLOCK:
            yield _f(src, node,
                     f"wall-clock `{path}()` outside the telemetry "
                     f"package: per-run values break replay; use "
                     f"simulated time, or justify with an ignore")
        elif len(segs) == 1:
            target = froms.get(path, "")
            if target in ("time.time", "time.time_ns", "time.monotonic",
                          "time.perf_counter"):
                yield _f(src, node,
                         f"wall-clock `{path}()` (from `time`) outside "
                         f"the telemetry package breaks replay")


def _f(src: SourceFile, node: ast.AST, message: str) -> Finding:
    return Finding(file=src.relpath, line=node.lineno, rule=RULE_ID,
                   severity="error", message=message)
