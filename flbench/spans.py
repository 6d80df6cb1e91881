"""Where a cell's time goes, by the program's own spans, on the chip.

    python3 flbench/spans.py --workload <cell> --seed <n> --seconds <s>

``run.py``'s traced run of the cell (``run.run_cell`` with ``--trace
1``), with the program's recorder (``repro_torch.telemetry.wallclock``)
on from before the build: one recorder over set-up (up to the window's
first round), one over the window, one over the profiled rounds.  The
profiled rounds' Chrome-trace events, which ``bench/trace.profile_rounds``
reduces with ``reduce_trace``, are also read by
``bench/spans.reduce_spans`` (idle device and runtime syncs by program
span).  One JSON line: ``run.py``'s result line, the six readings, the
set-up split, the largest spans, the training groups by width, and the
checks that tie the two reductions.  The benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import sys
import time
from pathlib import Path
from unittest import mock

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import run  # noqa: E402  (its clock starts the set-up)

#: spans listed in a run's line, by host time
TOP = 12
MIB = float(1 << 20)


class _Phases(contextlib.ExitStack):
    """One recorder a phase of the run, each started as the one before
    stops; ``starts`` holds each phase's start on the host clock."""

    def __init__(self, wallclock):
        super().__init__()
        self.wallclock = wallclock
        self.recs, self.starts = {}, {}

    def start(self, phase=None):
        self.close()
        self.starts[phase] = time.perf_counter()
        if phase is not None:
            self.recs[phase] = self.enter_context(
                self.wallclock.recording())


def measure(name: str, seed: int, seconds: float, *, device: str = "cuda",
            overrides: dict | None = None) -> dict:
    sys.path.insert(0, str(run.ROOT / "src"))
    from bench import program, spans as spans_mod, trace as trace_mod
    from repro_torch.telemetry import wallclock

    n_checked = run.load_cell(name, overrides)[4]["check"]["rounds"]
    phases = _Phases(wallclock)
    calls = itertools.count()
    kept = {}
    round_fn = program.Program.round
    profile_fn, reduce_fn = trace_mod.profile_rounds, trace_mod.reduce_trace

    def round_(prog):
        if next(calls) == n_checked:
            phases.start("window")
        round_fn(prog)

    def profile(step, n_rounds):
        phases.start("profiled")
        try:
            return profile_fn(step, n_rounds)
        finally:
            phases.start()

    def reduce(events):
        kept["events"] = events
        return reduce_fn(events)

    with phases, mock.patch.object(program.Program, "round", round_), \
            mock.patch.object(trace_mod, "profile_rounds", profile), \
            mock.patch.object(trace_mod, "reduce_trace", reduce):
        phases.start("setup")
        result, _ = run.run_cell(name, seed, seconds, True, device=device,
                                 overrides=overrides)

    setup, window, profiled = (phases.recs[k]
                               for k in ("setup", "window", "profiled"))
    events = kept.pop("events")
    names = set(setup.spans()) | set(window.spans()) | set(profiled.spans())
    tr = reduce_fn(events)
    sp = spans_mod.reduce_spans(events, names)
    per = float(run.PROFILED_ROUNDS)
    busy = spans_mod.device_busy(events)
    # the profiled rounds' k-th train.group record is the trace's k-th
    marks = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e.get("name") == "train.group"),
                   key=lambda e: e["ts"])
    del events
    stats, counters = window.spans(), window.counters()
    n_win = stats["round"].calls
    widths = {}

    def width(r):
        return widths.setdefault(r.info["alpha"],
                                 dict(r.info, host_ms=0.0, idle_ms=0.0))

    for r in _groups(window.records()):
        width(r)["host_ms"] += r.duration_ns * 1e-6 / n_win
    for r, e in zip(_groups(profiled.records()), marks):
        width(r)["idle_ms"] += spans_mod.idle_inside(
            busy, e["ts"], e["ts"] + e["dur"]) * 1e-3 / per

    idle, idle_self = sp.get("idle", {}), sp.get("idle_self", {})
    syncs = sp.get("syncs", {})
    st = setup.spans()
    kernels = st.get("setup.kernels")
    h2d = counters.get("h2d_bytes")
    phase_idle = tr.get("idle_by_phase", {})
    return {
        "workload": name, "seed": seed, "run": result,
        "readings": {
            "setup_data_s": _s(st, "setup.data"),
            "setup_kernels_s": kernels.total_ns * 1e-9 if kernels else None,
            "h2d_mib": h2d / n_win / MIB if h2d is not None else None,
            "host_syncs": syncs.get("round", 0) / per if sp else None,
            "train_idle_ms": 1e3 * idle.get("train", 0.0) / per,
            "decode_idle_ms": 1e3 * idle.get("materialize", 0.0) / per},
        "setup": _setup_split(setup, phases.starts["window"] - run.T0),
        "program_spans": [
            {"span": k, "calls": v.calls / n_win,
             "host_ms": v.total_ns * 1e-6 / n_win,
             "self_ms": v.self_ns * 1e-6 / n_win,
             "idle_ms": 1e3 * idle.get(k, 0.0) / per,
             "idle_self_ms": 1e3 * idle_self.get(k, 0.0) / per,
             "syncs": syncs.get(k, 0) / per}
            for k, v in sorted(stats.items(),
                               key=lambda kv: -kv[1].total_ns)[:TOP]],
        "train_groups": sorted(widths.values(), key=lambda w: w["alpha"]),
        "checks": {
            "window_round_s": result["round_ends_s"][-1] / n_win,
            "idle_in_rounds_ms": 1e3 * sp.get("idle_rounds_s", 0.0) / per,
            "idle_by_all_spans_ms": 1e3 * sum(idle_self.values()) / per,
            "phase_train_idle_ms": 1e3 * phase_idle.get("train", 0.0) / per,
            "phase_materialize_idle_ms":
                1e3 * phase_idle.get("materialize", 0.0) / per,
            "sync_events": sp.get("sync_events", 0)}}


def _groups(records) -> list:
    """The ``train.group`` records, in the order they opened."""
    return sorted((r for r in records if r.name == "train.group"),
                  key=lambda r: r.start_ns)


def _s(stats, name):
    st = stats.get(name)
    return st.total_ns * 1e-9 if st is not None else 0.0


def _setup_split(rec, setup_s: float) -> dict:
    """Set-up up to the window's first round, split: before the build
    (imports, CUDA's start, the seeded uniforms), the build by its parts,
    the kernels' build or load, the checked rounds less that, the rest
    (``gc``, the card's clocks)."""
    stats = rec.spans()
    build = next(r for r in rec.records() if r.name == "setup.build")
    kernels = _s(stats, "setup.kernels")
    rounds = _s(stats, "round") - kernels
    before = build.start_ns * 1e-9 - run.T0
    return {"setup_s": setup_s, "before_build_s": before,
            "build_s": _s(stats, "setup.build"),
            "data_s": _s(stats, "setup.data"),
            "model_s": _s(stats, "setup.model"),
            "fleet_s": _s(stats, "setup.fleet"),
            "test_h2d_s": _s(stats, "setup.test_h2d"),
            "kernels_s": kernels, "checked_rounds_s": rounds,
            "rest_s": setup_s - before - _s(stats, "setup.build")
            - kernels - rounds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.workload, args.seed, args.seconds)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
