"""Telemetry walkthrough on the PyTorch port: trace a run, read back its
metrics, check the no-op guarantee; on the card unless ``--device cpu``
is given.

Four short demonstrations of the observability layer:

1. the same hierarchical AnycostFL workload run twice — telemetry off
   and on — and the event-trace signatures + round records compared
   bitwise (tracing a seeded simulation cannot change it);
2. the flushed on-disk bundle: a Perfetto/Chrome trace you can drop
   into https://ui.perfetto.dev (one row per device/cell, train/uplink/
   backhaul spans, HANDOVER/EDGE_MERGE instants), a JSONL twin, the
   metrics registry dump, and a provenance manifest;
3. querying the metrics registry directly: per-phase energy totals,
   per-device uplink bits, the ``round.*`` gauges backing every
   ``RoundLog``;
4. per-phase cost attribution from the history itself —
   ``phase_totals()`` splits energy/latency/comm over
   shrink/train/compress/uplink/backhaul.

``PYTHONPATH=src python examples/torch_telemetry_run.py [--device cpu]
[--rounds R] [--devices N] [--n-train N]``
"""
import argparse
import dataclasses
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.mobility import HandoverConfig, MobilityConfig
from repro_torch.orchestrator.policies import OrchestratorConfig
from repro_torch.orchestrator.runner import run_orchestrated
from repro_torch.sysmodel.population import FleetConfig
from repro_torch.telemetry import Telemetry, build_manifest, validate_manifest
from repro_torch.topology import BackhaulConfig, TopologyConfig
from repro_torch.train.fl_loop import PHASES, FLRunConfig


def run(args, telemetry=None, cells=3):
    cfg = FLRunConfig(method="anycostfl", rounds=args.rounds,
                      n_train=args.n_train, n_test=128, eval_every=2,
                      lr=0.1, seed=0, use_planner=False)
    topo = TopologyConfig(
        kind="hier", n_cells=cells,
        handover=HandoverConfig(policy="nearest", margin_m=25.0),
        backhaul=BackhaulConfig(rate_bps=1e8, latency_s=0.05))
    fleet = FleetConfig(n_devices=args.devices, topology=topo,
                        mobility=MobilityConfig(kind="random_waypoint",
                                                seed=7,
                                                speed_range=(20.0, 40.0)))
    return run_orchestrated(cfg, fleet, OrchestratorConfig(policy="sync"),
                            device=args.device, telemetry=telemetry)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--devices", type=int, default=9)
    ap.add_argument("--n-train", type=int, default=512)
    args = ap.parse_args()
    if torch.device(args.device).type == "cuda":
        # cuDNN picks its convolution algorithms run by run, so two runs
        # of one configuration differ on the card in the last bits; the
        # bitwise comparison below needs its deterministic ones
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    print("== 1. telemetry is bitwise-invisible ==")
    plain = run(args)
    tel = Telemetry()
    traced = run(args, telemetry=tel)
    same_sig = plain.trace == traced.trace
    same_rows = all(dataclasses.asdict(a) == dataclasses.asdict(b)
                    for a, b in zip(plain.rounds, traced.rounds))
    print(f"trace signatures identical: {same_sig}")
    print(f"round records identical:    {same_rows}")
    assert same_sig and same_rows

    print("\n== 2. the flushed bundle ==")
    with tempfile.TemporaryDirectory() as d:
        manifest = build_manifest(traced.cfg, device=args.device,
                                  trace_signature=traced.trace)
        paths = tel.flush(manifest=manifest, out_dir=d)
        for kind, path in sorted(paths.items()):
            print(f"{kind:>13}: {os.path.basename(path)} "
                  f"({os.path.getsize(path)} bytes)")
        with open(paths["perfetto"]) as f:
            doc = json.load(f)
        spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
        instants = [e for e in doc["traceEvents"] if e["ph"] == "i"]
        print(f"perfetto: {len(spans)} spans, {len(instants)} instants, "
              f"span names {sorted({e['name'] for e in spans})}")
        print(f"manifest valid: {validate_manifest(manifest) == []} "
              f"(backend={manifest['backend']}, "
              f"sig={manifest['trace_signature_hash'][:12]}...)")

    print("\n== 3. querying the registry ==")
    reg = tel.registry
    for phase in PHASES:
        e = reg.total("cost.energy_j", phase=phase)
        print(f"  energy[{phase:>8}] = {e:10.3f} J")
    dev_bits = reg.series("cost.comm_bits", "device", phase="uplink")
    worst = max(dev_bits, key=lambda kv: kv[1]) if dev_bits else None
    print(f"  chattiest device: {worst[0]} ({worst[1] / 8e6:.2f} MB "
          f"uplinked over the run)")
    print(f"  handovers: {reg.total('mobility.handovers'):.0f}, "
          f"edge merges: {reg.total('backhaul.ships'):.0f}")
    acc = reg.series("round.test_acc", "round")
    print(f"  round.test_acc gauges: "
          f"{[(r, round(v, 3)) for r, v in acc]}")

    print("\n== 4. per-phase cost attribution ==")
    totals = traced.phase_totals()
    print(f"{'phase':>9} {'energy_j':>10} {'latency_s':>10} "
          f"{'comm_mb':>9}")
    for phase in PHASES:
        print(f"{phase:>9} {totals['energy_j'][phase]:>10.3f} "
              f"{totals['latency_s'][phase]:>10.3f} "
              f"{totals['comm_bits'][phase] / 8e6:>9.2f}")
    for r in traced.rounds:
        assert abs(sum(r.phase_energy().values()) - r.energy_j) < 1e-6
        assert abs(sum(r.phase_latency().values()) - r.latency_s) < 1e-6
    print("(components sum to the round totals — energy exactly, "
          "latency along the critical path)")


if __name__ == "__main__":
    main()
