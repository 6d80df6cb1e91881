"""Offline telemetry query CLI: slice a flushed bundle, no live run.

``PYTHONPATH=src python -m repro_torch.telemetry.query <cmd> --telemetry-dir D``
operates purely on the JSONL bundle a :class:`~repro_torch.telemetry.session.
Telemetry` session flushed — so a regression the bench gate flags can be
localized to a device/cell/phase **without re-running the simulation**:

* ``summary``  — the per-phase cost-attribution table, rebuilt from the
  ``round.*`` gauges in ``metrics.jsonl``.  The reconstruction replays
  ``History.phase_totals``'s exact summation (rounds ascending, starting
  from 0.0), so the totals are **bitwise identical** to what the live
  run printed under ``[cost attribution]`` (pinned by
  ``tests/test_torch_telemetry.py``).  ``--json`` dumps full precision.
* ``metric NAME [--labels cell=0] [--over round]`` — one metric swept
  over a label dimension as CSV (histogram points print their stats).
* ``spans [--top 10]`` — the slowest spans in ``trace.jsonl``, i.e.
  where the simulated timeline actually went.
* ``health`` — the run's health alerts from ``alerts.jsonl`` (written
  when the run was launched with ``--health``), one table row per
  alert; ``--json`` dumps the raw records.
* ``diff A/ B/`` — the cross-run differential: aligns two flush
  bundles by manifest (``# manifest mismatch`` warnings when the
  configs/seeds/versions disagree — the deltas are then apples to
  oranges) and reports per-phase cost-attribution deltas (**bitwise**:
  each side replays the live summation, the delta is one subtraction),
  per-cell energy deltas, dispatch-latency quantile deltas, and health
  alert-count deltas.  ``--json`` dumps the full diff document.

Every subcommand degrades explicitly on empty or partial bundles — a
bundle with no ``metrics.jsonl``, no ``round.*`` gauges, or no
``dispatch.latency_s`` observations prints a "no data" line instead of
raising (a half-flushed run is still inspectable, and ``diff`` against
a half-flushed run reports what it can).

The phase axis and its RoundLog field mapping live here as the offline
single source; ``repro_torch.train.fl_loop`` keeps the live (identical)
definitions and the tests assert they agree.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from repro_torch.telemetry.manifest import manifest_mismatches
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.sketch import QuantileSketch

ROUND_PREFIX = "round."

# canonical cost-attribution axis (== repro_torch.train.fl_loop.PHASES) and
# the RoundLog field carrying each (metric, phase) cell; absent phases
# are explicit zeros in the live attribution and stay zeros here
PHASES = ("shrink", "train", "compress", "uplink", "backhaul")
PHASE_FIELDS = {
    "energy_j": {"train": "energy_train_j", "uplink": "energy_uplink_j",
                 "backhaul": "energy_backhaul_j"},
    "latency_s": {"train": "latency_train_s",
                  "uplink": "latency_uplink_s",
                  "backhaul": "latency_backhaul_s"},
    "comm_bits": {"uplink": "comm_bits"},
}


def load_registry(telemetry_dir: str) -> MetricsRegistry:
    """Rebuild the run's registry from ``<dir>/metrics.jsonl``.

    A missing file yields an *empty* registry rather than raising, so
    the subcommands can report "no data" on partial bundles."""
    path = os.path.join(telemetry_dir, "metrics.jsonl")
    if not os.path.exists(path):
        return MetricsRegistry()
    with open(path) as f:
        return MetricsRegistry.from_records(
            json.loads(line) for line in f if line.strip())


def load_manifest(telemetry_dir: str) -> Optional[dict]:
    """``<dir>/manifest.json`` as a dict, or None when absent/unreadable
    (the diff degrades with a "# no data" line instead of raising)."""
    path = os.path.join(telemetry_dir, "manifest.json")
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def round_indices(reg: MetricsRegistry) -> list:
    """Every round index any ``round.*`` gauge was emitted for."""
    rounds: set = set()
    for name in reg.names():
        if name.startswith(ROUND_PREFIX):
            rounds.update(reg.label_values(name, "round"))
    return sorted(rounds)


def phase_totals(reg: MetricsRegistry) -> dict:
    """``History.phase_totals`` recomputed from the registry alone.

    Same accumulation order as the live method — per metric/phase,
    start at 0.0 and add each round's value in ascending round order
    (absent gauges contribute the RoundLog default 0.0) — which makes
    the result bitwise-equal to the live totals.
    """
    totals = {metric: dict.fromkeys(PHASES, 0.0) for metric in PHASE_FIELDS}
    rounds = round_indices(reg)
    for metric, fields in PHASE_FIELDS.items():
        for r in rounds:
            for phase in PHASES:
                field = fields.get(phase)
                v = reg.value(ROUND_PREFIX + field, round=r) \
                    if field is not None else 0.0
                totals[metric][phase] += v if v is not None else 0.0
    return totals


def format_cost_table(totals: dict) -> str:
    """The exact ``[cost attribution]`` table the live runner prints."""
    lines = ["[cost attribution]",
             f"  {'phase':>9s} {'energy_j':>12s} {'latency_s':>12s} "
             f"{'comm_mb':>12s}"]
    for phase in PHASES:
        lines.append(f"  {phase:>9s} {totals['energy_j'][phase]:12.3f} "
                     f"{totals['latency_s'][phase]:12.3f} "
                     f"{totals['comm_bits'][phase] / 8e6:12.3f}")
    return "\n".join(lines)


def _parse_labels(spec: Optional[str]) -> dict:
    """``cell=0,phase=train`` -> {"cell": 0, "phase": "train"} (ints and
    floats coerced so filters match the emitted label types)."""
    labels: dict = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise SystemExit(f"bad label filter {part!r} (want key=value)")
        k, v = part.split("=", 1)
        try:
            labels[k] = int(v)
        except ValueError:
            try:
                labels[k] = float(v)
            except ValueError:
                labels[k] = v
        continue
    return labels


def cmd_summary(args) -> int:
    reg = load_registry(args.telemetry_dir)
    totals = phase_totals(reg)
    if args.json:
        print(json.dumps(totals, indent=1))
        return 0
    if not round_indices(reg):
        print("# no data: no round.* gauges in bundle "
              f"({os.path.join(args.telemetry_dir, 'metrics.jsonl')})")
    print(format_cost_table(totals))
    hist = reg.summary("dispatch.latency_s")
    if hist is not None:
        print(f"[dispatch latency] n={hist['count']} "
              f"p50={hist['p50']:.3f}s p95={hist['p95']:.3f}s "
              f"p99={hist['p99']:.3f}s max={hist['max']:.3f}s")
    else:
        print("[dispatch latency] no observations")
    top = reg.top_devices("dispatch.latency_s", k=5)
    if top:
        print("[top stragglers] "
              + "  ".join(f"device {dev}: {v:.3f}s" for dev, v in top))
    return 0


def cmd_health(args) -> int:
    path = os.path.join(args.telemetry_dir, "alerts.jsonl")
    if not os.path.exists(path):
        print("# no alerts.jsonl in bundle (run with --health)")
        return 0
    alerts = []
    with open(path) as f:
        for line in f:
            if line.strip():
                alerts.append(json.loads(line))
    if args.json:
        print(json.dumps(alerts, indent=1))
        return 0
    if not alerts:
        print("[health] 0 alerts")
        return 0
    print(f"[health] {len(alerts)} alert(s)")
    print(f"  {'round':>5s} {'severity':>8s} {'rule':>20s} "
          f"{'value':>12s} {'threshold':>12s}  message")
    for a in alerts:
        print(f"  {a['round']:>5d} {a['severity']:>8s} {a['rule']:>20s} "
              f"{a['value']:>12.4g} {a['threshold']:>12.4g}  "
              f"{a['message']}")
    return 0


def cmd_metric(args) -> int:
    reg = load_registry(args.telemetry_dir)
    if args.name not in reg:
        known = ", ".join(reg.names())
        raise SystemExit(f"metric {args.name!r} not in bundle "
                         f"(have: {known})")
    labels = _parse_labels(args.labels)
    rows = reg.series(args.name, args.over, **labels)
    print(f"{args.over},value")
    for over_value, value in rows:
        if isinstance(value, QuantileSketch):  # rolled-up cell
            stats = {"count": value.count, "sum": value.sum,
                     "p50": value.quantile(0.5),
                     "p95": value.quantile(0.95)}
            print(f"{over_value},{json.dumps(stats)}")
        elif isinstance(value, list):          # histogram cell
            stats = {"count": len(value), "sum": sum(value)}
            print(f"{over_value},{json.dumps(stats)}")
        else:
            print(f"{over_value},{value}")
    if not rows:
        print(f"# no {args.name!r} entries carry an "
              f"{args.over!r} label matching {labels}")
    return 0


def cmd_spans(args) -> int:
    path = os.path.join(args.telemetry_dir, "trace.jsonl")
    if not os.path.exists(path):
        print("# no trace.jsonl in bundle")
        return 0
    spans = []
    with open(path) as f:
        for line in f:
            row = json.loads(line)
            if row.get("type") == "span":
                spans.append((row["t1"] - row["t0"], row))
    spans.sort(key=lambda s: (-s[0], s[1]["track"], s[1]["name"]))
    print(f"{'dur_s':>10s} {'t0':>10s} {'track':>12s} name")
    for dur, row in spans[:args.top]:
        extra = {k: v for k, v in (row.get("args") or {}).items()
                 if k in ("round", "cell", "bits", "energy_j")}
        print(f"{dur:10.4f} {row['t0']:10.2f} {row['track']:>12s} "
              f"{row['name']}"
              + (f"  {json.dumps(extra)}" if extra else ""))
    if not spans:
        print("# no spans in bundle")
    return 0


# ------------------------------------------------------------------ diff

def _alert_counts(telemetry_dir: str) -> Optional[dict]:
    """``{rule: count}`` from ``alerts.jsonl``; None when absent."""
    path = os.path.join(telemetry_dir, "alerts.jsonl")
    if not os.path.exists(path):
        return None
    counts: dict = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                rule = json.loads(line).get("rule", "?")
                counts[rule] = counts.get(rule, 0) + 1
    return counts


def bundle_diff(dir_a: str, dir_b: str) -> dict:
    """The full cross-run differential of two flush bundles as a dict.

    Pure function of the two bundles' files; every delta is ``b - a``.
    The phase-attribution deltas are bitwise-faithful: each side is
    :func:`phase_totals` (the pinned replay of the live summation) and
    the delta is a single float subtraction — no re-simulation, no
    re-accumulation.  Missing pieces land in ``no_data`` instead of
    raising."""
    no_data: list[str] = []
    regs = {}
    for tag, d in (("a", dir_a), ("b", dir_b)):
        if not os.path.exists(os.path.join(d, "metrics.jsonl")):
            no_data.append(f"{tag}: no metrics.jsonl in {d}")
        regs[tag] = load_registry(d)
    manifests = {tag: load_manifest(d)
                 for tag, d in (("a", dir_a), ("b", dir_b))}
    for tag, d in (("a", dir_a), ("b", dir_b)):
        if manifests[tag] is None:
            no_data.append(f"{tag}: no manifest.json in {d}")
    mismatches = manifest_mismatches(manifests["a"], manifests["b"]) \
        if None not in manifests.values() else []

    totals = {tag: phase_totals(regs[tag]) for tag in ("a", "b")}
    for tag in ("a", "b"):
        if not round_indices(regs[tag]):
            no_data.append(f"{tag}: no round.* gauges")
    delta = {metric: {phase: totals["b"][metric][phase]
                      - totals["a"][metric][phase]
                      for phase in PHASES}
             for metric in PHASE_FIELDS}

    cells: dict = {}
    cell_ids = sorted(set(regs["a"].label_values("cost.energy_j", "cell"))
                      | set(regs["b"].label_values("cost.energy_j",
                                                   "cell")))
    for c in cell_ids:
        ea = regs["a"].total("cost.energy_j", cell=c)
        eb = regs["b"].total("cost.energy_j", cell=c)
        cells[str(c)] = {"a": ea, "b": eb, "delta": eb - ea}

    dispatch = {tag: regs[tag].summary("dispatch.latency_s")
                for tag in ("a", "b")}
    dispatch["delta"] = None
    if dispatch["a"] is not None and dispatch["b"] is not None:
        dispatch["delta"] = {k: dispatch["b"][k] - dispatch["a"][k]
                             for k in ("p50", "p95", "p99", "max")}

    alerts = {tag: _alert_counts(d)
              for tag, d in (("a", dir_a), ("b", dir_b))}
    alert_delta = None
    if alerts["a"] is not None and alerts["b"] is not None:
        rules = sorted(set(alerts["a"]) | set(alerts["b"]))
        alert_delta = {r: alerts["b"].get(r, 0) - alerts["a"].get(r, 0)
                       for r in rules}

    return {"a": dir_a, "b": dir_b,
            "manifest_mismatches": mismatches,
            "no_data": no_data,
            "phase_totals": {"a": totals["a"], "b": totals["b"],
                             "delta": delta},
            "cell_energy_j": cells,
            "dispatch": dispatch,
            "alerts": {"a": alerts["a"], "b": alerts["b"],
                       "delta": alert_delta}}


def cmd_diff(args) -> int:
    doc = bundle_diff(args.dir_a, args.dir_b)
    if args.json:
        print(json.dumps(doc, indent=1))
        return 0
    for line in doc["no_data"]:
        print(f"# no data: {line}")
    for line in doc["manifest_mismatches"]:
        print(f"# manifest mismatch: {line}")
    if doc["manifest_mismatches"]:
        print("# manifest mismatch: deltas below compare bundles from "
              "DIFFERENT configurations — interpret with care")
    print(f"[phase attribution delta] b - a  (a={doc['a']} b={doc['b']})")
    print(f"  {'phase':>9s} {'d_energy_j':>12s} {'d_latency_s':>12s} "
          f"{'d_comm_mb':>12s}")
    d = doc["phase_totals"]["delta"]
    for phase in PHASES:
        print(f"  {phase:>9s} {d['energy_j'][phase]:12.3f} "
              f"{d['latency_s'][phase]:12.3f} "
              f"{d['comm_bits'][phase] / 8e6:12.3f}")
    if doc["cell_energy_j"]:
        print("[cell energy delta]")
        print(f"  {'cell':>6s} {'a':>12s} {'b':>12s} {'delta':>12s}")
        for c, row in doc["cell_energy_j"].items():
            print(f"  {c:>6s} {row['a']:12.3f} {row['b']:12.3f} "
                  f"{row['delta']:12.3f}")
    else:
        print("# no data: no per-cell cost.energy_j in either bundle")
    disp = doc["dispatch"]
    if disp["delta"] is not None:
        print("[dispatch latency delta] "
              + " ".join(f"d_{k}={disp['delta'][k]:+.4f}s"
                         for k in ("p50", "p95", "p99", "max"))
              + f"  (n: {disp['a']['count']} -> {disp['b']['count']})")
    else:
        print("# no data: dispatch.latency_s missing from a bundle")
    al = doc["alerts"]
    if al["delta"] is not None:
        if al["delta"]:
            print("[health alert delta]")
            for rule, dv in al["delta"].items():
                print(f"  {rule:>24s} {dv:+d}")
        else:
            print("[health alert delta] none (0 alerts on both sides)")
    else:
        print("# no data: alerts.jsonl missing from a bundle "
              "(run with --health)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.query",
        description="Slice a flushed telemetry bundle offline.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("summary", help="per-phase cost attribution table")
    p.add_argument("--telemetry-dir", required=True)
    p.add_argument("--json", action="store_true",
                   help="full-precision JSON instead of the table")
    p.set_defaults(fn=cmd_summary)

    p = sub.add_parser("metric", help="one metric swept over a label")
    p.add_argument("name")
    p.add_argument("--telemetry-dir", required=True)
    p.add_argument("--labels", default=None,
                   help="filter, e.g. cell=0,phase=train")
    p.add_argument("--over", default="round",
                   help="label dimension to sweep (default: round)")
    p.set_defaults(fn=cmd_metric)

    p = sub.add_parser("spans", help="slowest spans in the timeline")
    p.add_argument("--telemetry-dir", required=True)
    p.add_argument("--top", type=int, default=10)
    p.set_defaults(fn=cmd_spans)

    p = sub.add_parser("diff", help="cross-run differential of two "
                                    "flush bundles (deltas are b - a)")
    p.add_argument("dir_a", help="baseline bundle directory (a)")
    p.add_argument("dir_b", help="candidate bundle directory (b)")
    p.add_argument("--json", action="store_true",
                   help="full-precision diff document instead of tables")
    p.set_defaults(fn=cmd_diff)

    p = sub.add_parser("health", help="health alerts from alerts.jsonl")
    p.add_argument("--telemetry-dir", required=True)
    p.add_argument("--json", action="store_true",
                   help="raw alert records instead of the table")
    p.set_defaults(fn=cmd_health)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
