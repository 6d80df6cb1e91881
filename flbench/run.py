"""Run one cell of the AnycostFL port's benchmark once.

    python3 flbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  ``BENCHMARK.json`` names the cell's
configuration and traffic; their files are ``flbench/configs/<config>.json``
and ``flbench/traffic/<traffic>.json``, and the cell's own settings (why,
the checked rounds, the limits of the comparison) are
``flbench/workloads/<cell>.json``.  The configuration names its program
(``"program"``), the module ``flbench/programs/<program>.py`` that builds
the system under test and follows it with the plain reference
(``programs/__init__.py``).  Every metric is read by
``flbench/metrics/<name>.py``.

A run builds the program from the seed and drives its checked rounds
(set-up: they warm up every shape, and what they produce is recorded),
then measures whole rounds for ``--seconds``.  With ``--trace 1`` the
program's hooks may time the window's rounds phase by phase, and more
rounds (two, or the cell's ``profiled_rounds``) run under
``torch.profiler``.  Once the window has closed
and the program's state is freed, the plain reference judges what the
checked rounds produced and the comparison decides ``correct``.
The last line of standard output is the result; the numbers compared,
each beside its limit, are the last lines of standard error.

The run's context (``ctx``) that the metric readers take holds
``setup_s``, ``window_s``, ``window_rounds``, ``window_peak_bytes``, and
with ``--trace 1`` also ``spans`` (seconds per phase over ``span_rounds``
rounds, where the program's hooks time them), ``profiled_rounds``,
``trace`` (``bench/trace.reduce_trace``), ``launches`` (the program's
kernel launch counts over the profiled rounds) and ``shape`` (what the
profiled rounds computed: ``flops`` and the ``peak`` they are held
against, and the program's own sizes for the kernels' rooflines).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import os  # noqa: E402

# one host thread for the numerical libraries: the round loop's host work
# is Python dispatch, and idle worker threads only contend with it
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: rounds under the profiler in a traced run, unless the cell's settings
#: name another count (``profiled_rounds``: a long round's trace takes
#: minutes to export and read)
PROFILED_ROUNDS = 2


class RunError(RuntimeError):
    """A run that prints no result."""


def load_cell(name: str, overrides: dict | None = None):
    """(bench entry, config, traffic, cell settings) of a cell;
    ``overrides`` replaces keys of the configuration's groups and, under
    ``"traffic"``, of the traffic mix."""
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise RunError(f"no workload {name!r} in BENCHMARK.json")
    config = json.loads(
        (HERE / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    cell = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    for group, values in (overrides or {}).items():
        (traffic if group == "traffic" else config[group]).update(values)
    return manifest, entry, config, traffic, cell


def metric_names(manifest: dict, entry: dict, trace: bool) -> list[str]:
    """The cell's end-to-end metrics (trace 0) or per-layer ones (1)."""
    e2e = [m for m in manifest["end_to_end"]
           if entry["name"] in m.get("workloads", [entry["name"]])]
    if not trace:
        return [m["name"] for m in e2e]
    moved = {m["name"] for m in e2e}
    return [m["name"] for m in manifest["per_layer"]
            if entry["name"] in m.get("workloads", [entry["name"]])
            and m["moves"] in moved]


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def smi(query: str) -> str | None:
    """One ``nvidia-smi`` reading of the first card, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


#: the card's state beside the window (read before and after it)
CLOCKS = "clocks.sm,clocks.mem,temperature.gpu,power.draw"


def program_module(config: dict):
    """The module of the program the configuration names."""
    return importlib.import_module(f"programs.{config['program']}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", overrides: dict | None = None,
             fault=None) -> tuple[dict, list[str]]:
    """One run of a cell -> (result line, lines for standard error).

    ``overrides`` replaces groups of the configuration (the tests' small
    sizes); ``fault(prog)``, where given, breaks the program under the
    window (the tests' planted faults)."""
    import torch

    from bench import check, trace as trace_mod

    manifest, entry, config, traffic, cell = load_cell(name, overrides)
    on_cuda = device == "cuda"
    sync = torch.cuda.synchronize if on_cuda else (lambda: None)
    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    mod = program_module(config)

    # -------------------------------------------------------------- set-up
    prog = mod.build(config, traffic, cell, seed, device)
    try:
        if fault is not None:
            fault(prog)
        prog.checked()
        sync()
        # what set-up left (the data, the capture) is not the window's to
        # walk
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - T0

        # ---------------------------------------------------------- window
        if on_cuda:
            pre_peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        hooks = prog.timed_hooks() if trace else None
        ctx = {"setup_s": setup_s}
        clocks = [smi(CLOCKS)] if on_cuda else []
        with hooks or contextlib.nullcontext():
            t_start = time.perf_counter()
            ends = []
            while True:
                prog.round()
                ends.append(time.perf_counter() - t_start)
                if ends[-1] >= seconds:
                    break
            ctx["window_s"] = ends[-1]
        if on_cuda:
            clocks.append(smi(CLOCKS))
        n = ctx["window_rounds"] = len(ends)
        ctx["window_peak_bytes"] = torch.cuda.max_memory_allocated() \
            if on_cuda else 0
        if trace:
            ctx["spans"] = hooks.take_spans() if hooks is not None else {}
            ctx["span_rounds"] = n
            n_prof = ctx["profiled_rounds"] = cell.get("profiled_rounds",
                                                       PROFILED_ROUNDS)
            ctx.update(prog.profiled(trace_mod, n_prof))
        peak = max(pre_peak, torch.cuda.max_memory_allocated()) \
            if on_cuda else 0
        forbidden = loaded_forbidden()

        # --------------------------------------------- the comparison
        cap = prog.release()
    finally:
        close = getattr(prog, "close", None)
        if close is not None:
            close()
    del prog, hooks
    gc.unfreeze()
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    nums = mod.follow(config, traffic, cell, seed, device, cap)
    correct, shown = check.judge(nums, cell["check"]["limits"])
    forbidden = sorted(set(forbidden) | set(loaded_forbidden()))
    if forbidden:
        raise RunError("modules loaded that the port may not use: "
                       + ", ".join(forbidden))

    # ------------------------------------------------------------- result
    metrics = {}
    units = {m["name"]: m["unit"]
             for m in manifest["end_to_end"] + manifest["per_layer"]}
    for mname in metric_names(manifest, entry, trace):
        value = importlib.import_module(f"metrics.{mname}").read(ctx)
        if value is not None:
            metrics[mname] = {"value": float(value), "unit": units[mname]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if on_cuda:
        dev["power"] = smi("name,power.limit")
    result = {"correct": bool(correct), "attempted": n, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace:
        tr = ctx.get("trace") or {}
        dev["busy_s"] = tr.get("busy_s", 0.0)
        dev["window_s"] = tr.get("window_s", 0.0)
        result["breakdown"] = {
            "device_ops": trace_mod.top(tr.get("kernels", {})),
            "idle_gaps": trace_mod.top(tr.get("idle_by_phase", {}))}
    # each round's end in the window, seconds, and the card's clocks
    # before and after it (ignored by the driver)
    result["round_ends_s"] = ends
    result["clocks"] = clocks
    result["readings"] = nums
    result["check"] = shown
    lines = [f"check {k}: {v:.6g} limit {lim:.6g}"
             for k, (v, lim) in shown.items()]
    lines += [f"reading {k}: {nums[k]:.6g} (no limit)" for k in nums
              if k not in shown]
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    try:
        manifest, entry, *_ = load_cell(args.workload)
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < entry["chips"]:
            raise RunError(f"the cell needs {entry['chips']} CUDA "
                           f"device(s); "
                           f"{torch.cuda.device_count()} available")
        result, lines = run_cell(args.workload, args.seed, args.seconds,
                                 bool(args.trace))
    except RunError as e:
        print(f"flbench: {e}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
