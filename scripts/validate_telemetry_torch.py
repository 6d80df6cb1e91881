#!/usr/bin/env python
"""Validate the port's telemetry bundles (``repro_torch`` only).

Two checks, each selectable:

* ``--run``       drive a tiny telemetry-enabled hierarchical run (6
                  devices, 2 cells, 2 rounds) on ``cuda``, or on the CPU
                  with ``--device cpu``, with a :class:`HealthEngine`
                  attached, so the bundle carries ``learning.*`` metrics,
                  ALERT instants and a non-empty ``alerts.jsonl``; flush
                  it into a temp dir, validate it, and check that
                  ``query health`` renders it.  On the card the run goes
                  through the hierarchical round's kernels and fails
                  where one fails;
* ``--dir D``     validate an existing bundle directory: the Perfetto
                  JSON must parse and type-check (metadata declares
                  every (pid, tid); X spans carry numeric ts/dur >= 0;
                  instants carry s:"t"), the JSONL twin must line-parse
                  with the span/instant schema, metrics.jsonl must
                  line-parse, ``alerts.jsonl`` (when present) must
                  line-parse with the exact ``ALERT_KEYS`` schema, and
                  manifest.json must pass ``validate_manifest``.

The reference's ``--artifacts`` check is left out: it reads the
benchmark artifacts' embedded manifests, and the port has no benchmark
artifacts.

Exit code 0 = everything valid.  Run as
``PYTHONPATH=src python scripts/validate_telemetry_torch.py --run
[--device cpu] [--dir D]``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.telemetry import ALERT_KEYS, validate_manifest  # noqa: E402

SPAN_KEYS = {"name", "cat", "ph", "ts", "dur", "pid", "tid"}
INSTANT_KEYS = {"name", "cat", "ph", "s", "ts", "pid", "tid"}
JSONL_KEYS = {"type", "track", "name", "t0", "t1", "args"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}")
    raise SystemExit(1)


def validate_perfetto(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        fail(f"{path}: traceEvents missing or empty")
    declared = set()
    counts = {"M": 0, "X": 0, "i": 0}
    for ev in events:
        ph = ev.get("ph")
        if ph not in counts:
            fail(f"{path}: unknown phase {ph!r} in {ev}")
        counts[ph] += 1
        if ph == "M":
            declared.add((ev["pid"], ev["tid"]))
            continue
        missing = (SPAN_KEYS if ph == "X" else INSTANT_KEYS) - set(ev)
        if missing:
            fail(f"{path}: {ph} event missing {sorted(missing)}: {ev}")
        if (ev["pid"], ev["tid"]) not in declared:
            fail(f"{path}: event on undeclared track {ev}")
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            fail(f"{path}: bad ts in {ev}")
        if ph == "X" and (not isinstance(ev["dur"], (int, float))
                          or ev["dur"] < 0):
            fail(f"{path}: bad dur in {ev}")
        if ph == "i" and ev["s"] not in ("t", "p", "g"):
            fail(f"{path}: bad instant scope in {ev}")
    if counts["X"] == 0:
        fail(f"{path}: no spans at all — empty timeline")
    return counts


def validate_alerts(path: str) -> int:
    """Schema-check every ``alerts.jsonl`` record: exact key set, typed
    round/value/threshold, known severity."""
    n = 0
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = json.loads(line)
            if set(rec) != set(ALERT_KEYS):
                fail(f"{path}: alert keys {sorted(rec)} != "
                     f"{sorted(ALERT_KEYS)}")
            if not isinstance(rec["round"], int):
                fail(f"{path}: non-integer round in {rec}")
            for key in ("t", "value", "threshold"):
                if not isinstance(rec[key], (int, float)):
                    fail(f"{path}: non-numeric {key!r} in {rec}")
            if rec["severity"] not in ("warning", "critical"):
                fail(f"{path}: bad severity in {rec}")
            n += 1
    return n


def validate_bundle(out_dir: str) -> None:
    counts = validate_perfetto(os.path.join(out_dir, "trace.perfetto.json"))
    n_jsonl = 0
    with open(os.path.join(out_dir, "trace.jsonl")) as f:
        for line in f:
            row = json.loads(line)
            if set(row) != JSONL_KEYS:
                fail(f"trace.jsonl row keys {sorted(row)} != schema")
            if row["type"] not in ("span", "instant"):
                fail(f"trace.jsonl bad type in {row}")
            n_jsonl += 1
    if n_jsonl != counts["X"] + counts["i"]:
        fail(f"trace.jsonl has {n_jsonl} rows; perfetto has "
             f"{counts['X'] + counts['i']} events")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        n_metrics = sum(1 for line in f if json.loads(line))
    alerts_path = os.path.join(out_dir, "alerts.jsonl")
    n_alerts = validate_alerts(alerts_path) \
        if os.path.exists(alerts_path) else None
    manifest_path = os.path.join(out_dir, "manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            missing = validate_manifest(json.load(f))
        if missing:
            fail(f"{manifest_path} missing keys {missing}")
    print(f"OK bundle {out_dir}: {counts['X']} spans, {counts['i']} "
          f"instants, {n_metrics} metric records"
          + (f", {n_alerts} alerts" if n_alerts is not None else ""))


def tiny_configs() -> tuple:
    """The tiny run's (run config, fleet, orchestrator config)."""
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.topology import TopologyConfig
    from repro_torch.train.fl_loop import FLRunConfig

    run_cfg = FLRunConfig(method="anycostfl", rounds=2, n_train=128,
                          n_test=64, eval_every=1, lr=0.1, seed=0,
                          use_planner=False)
    fleet = FleetConfig(n_devices=6,
                        topology=TopologyConfig(kind="hier", n_cells=2))
    return run_cfg, fleet, OrchestratorConfig(policy="sync")


def tiny_run(out_dir: str, device: str = "cuda"):
    """The tiny ``--health`` run, flushed into ``out_dir``; returns its
    history."""
    from repro_torch.orchestrator.runner import run_orchestrated
    from repro_torch.telemetry import (HealthEngine, HealthRule, Telemetry,
                                       build_manifest)

    run_cfg, fleet, orch = tiny_configs()
    tel = Telemetry(out_dir)
    # a zero-threshold saturation rule fires on every hierarchical round
    # (any backhaul at all), so the validated bundle always carries a
    # non-empty alerts.jsonl exercising the full --health path
    tel.health = HealthEngine((
        HealthRule("any-backhaul", "backhaul_saturation",
                   params={"threshold": 0.0}),))
    hist = run_orchestrated(run_cfg, fleet, orch, device=device,
                            telemetry=tel)
    if not tel.health.alerts():
        fail("tiny --health run produced no alerts (zero-threshold "
             "saturation rule must fire on a hierarchical run)")
    if not any(n.startswith("learning.") for n in tel.registry.names()):
        fail("tiny --health run emitted no learning.* metrics")
    tel.flush(manifest=build_manifest(run_cfg, fleet, orch, device=device,
                                      trace_signature=hist.trace))
    return hist


def check_query_health(out_dir: str) -> None:
    """``query health`` must render the freshly flushed alerts."""
    import contextlib
    import io

    from repro_torch.telemetry import query
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = query.main(["health", "--telemetry-dir", out_dir])
    out = buf.getvalue()
    if rc != 0 or "[health]" not in out or "alert" not in out:
        fail(f"query health on {out_dir} returned {rc}: {out!r}")
    print(f"OK query health {out_dir}: {out.splitlines()[0]}")


def main(argv=None):
    """Returns the ``--run``'s history (None without ``--run``)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--run", action="store_true",
                    help="generate a tiny bundle and validate it")
    ap.add_argument("--device", default="cuda",
                    help="device of the --run (cuda unless 'cpu')")
    ap.add_argument("--dir", default=None,
                    help="existing telemetry bundle directory to validate")
    args = ap.parse_args(argv)
    if not (args.run or args.dir):
        ap.error("nothing to do: pass --run and/or --dir")
    hist = None
    if args.run:
        with tempfile.TemporaryDirectory() as d:
            hist = tiny_run(d, args.device)
            validate_bundle(d)
            check_query_health(d)
    if args.dir:
        validate_bundle(args.dir)
    return hist


if __name__ == "__main__":
    main()
