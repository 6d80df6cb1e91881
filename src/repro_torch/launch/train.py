"""FL training entry point: AnycostFL and the Table I baselines under the
sync, semisync or fedbuff policy, on a flat fleet or (round-based
policies) a client -> edge -> cloud hierarchy, static or dynamic, fixed
or moving.

  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --method anycostfl --rounds 40 --devices 12 [--device cpu] \\
      [--arch vgg9-cifar] [--non-iid] \\
      [--async-mode semisync --deadline 8 --straggler-mode downweight] \\
      [--async-mode fedbuff --buffer-size 8 --max-wallclock 300] \\
      [--topology hier --cells 4 --backhaul-codec int8 --backhaul-ef] \\
      [--availability markov --battery on --selection gain \\
       --participation 0.5] \\
      [--mobility random_waypoint --speed 30 --handover-policy nearest] \\
      [--mobility replay --scenario-trace world.json \\
       --availability replay] \\
      [--telemetry-dir out/ --health --telemetry-rollup 64 \\
       --trace-sample 0.25 --torch-profile]

``--method`` is one of ``train/fl_loop.METHODS``; ``--arch`` names one of
the paper's two models (an LM family raises ``NotImplementedError``).

Runs on the CUDA card unless ``--device cpu`` is given, and prints the
reference launcher's final JSON fields and the per-phase cost
attribution.  ``--telemetry-dir`` attaches a telemetry session and
writes its bundle there (``trace.perfetto.json``, ``trace.jsonl``,
``metrics.jsonl``, ``manifest.json``, and ``alerts.jsonl`` under
``--health``); ``python -m repro_torch.telemetry.query`` reads it.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.fleet import (AvailabilityConfig, BatteryConfig,
                               FleetDynamicsConfig)
from repro_torch.mobility import HandoverConfig, MobilityConfig
from repro_torch.orchestrator.policies import POLICIES, OrchestratorConfig
from repro_torch.orchestrator.runner import run_orchestrated
from repro_torch.sysmodel.population import FleetConfig
from repro_torch.telemetry import (DEFAULT_RULES, NULL_TELEMETRY,
                                   HealthEngine, RollupPolicy, Telemetry,
                                   build_manifest, load_rules)
from repro_torch.topology import BackhaulConfig, TopologyConfig
from repro_torch.train.fl_loop import METHODS, PHASES, FLRunConfig


def _dynamics_config(args):
    """The fleet-dynamics control plane from the flags.  The defaults
    (``--availability always --battery off --selection uniform``) build a
    config that gives the static fleet bit for bit."""
    avail = AvailabilityConfig(
        kind=args.availability,
        seed=args.availability_seed
        if args.availability_seed is not None else args.seed,
        # one scenario file can drive positions and availability
        trace_file=args.trace_file or args.scenario_trace)
    battery = None
    if args.battery == "on":
        battery = BatteryConfig(capacity_j=args.battery_capacity,
                                recharge_w=args.battery_recharge,
                                seed=args.seed)
    return FleetDynamicsConfig(
        availability=avail, battery=battery, selection=args.selection,
        participation=args.participation,
        selection_seed=args.selection_seed,
        soc_deadline_scale=args.soc_deadline_scale,
        soc_deadline_threshold=args.soc_deadline_threshold)


def _mobility_config(args):
    """Device motion from the flags; None for ``static`` (the paper's
    per-round position re-drop)."""
    if args.mobility == "static":
        return None
    return MobilityConfig(
        kind=args.mobility,
        seed=args.mobility_seed if args.mobility_seed is not None
        else args.seed,
        speed_range=(0.5 * args.speed, 1.5 * args.speed),
        mean_speed=args.speed, scenario_file=args.scenario_trace)


def _topology_config(args):
    """The multi-cell topology from the flags; None for ``flat``."""
    if args.topology == "flat":
        return None
    handover = None
    if args.mobility != "static" and args.handover_policy != "none":
        handover = HandoverConfig(policy=args.handover_policy,
                                  margin_m=args.handover_margin)
    return TopologyConfig(
        kind="hier", n_cells=args.cells,
        assignment=args.cell_assignment,
        cell_radius_scale=args.cell_radius_scale,
        cell_deadline_s=args.cell_deadline,
        handover=handover,
        backhaul_rate_range=(tuple(args.backhaul_rate_range)
                             if args.backhaul_rate_range else None),
        backhaul_het_seed=args.seed,
        backhaul=BackhaulConfig(
            rate_bps=args.backhaul_rate,
            latency_s=args.backhaul_latency,
            energy_per_bit=args.backhaul_energy,
            codec=args.backhaul_codec,
            error_feedback=args.backhaul_ef))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="fl", choices=["fl"])
    ap.add_argument("--arch", default="fmnist-cnn",
                    help="fmnist-cnn or vgg9-cifar (the LM families "
                         "arrive with the pod path)")
    ap.add_argument("--method", default="anycostfl", choices=METHODS)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--devices", type=int, default=12)
    ap.add_argument("--non-iid", action="store_true",
                    help="Dirichlet(0.5) label partition instead of iid")
    ap.add_argument("--n-train", type=int, default=1536)
    ap.add_argument("--n-test", type=int, default=384)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    # ---- arrival policy
    ap.add_argument("--async-mode", default="sync", choices=POLICIES)
    ap.add_argument("--max-wallclock", type=float, default=None,
                    help="stop after this many *simulated* seconds "
                         "(fedbuff: overrides --rounds)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="semisync cutoff in seconds (default: fleet T_max)")
    ap.add_argument("--buffer-size", type=int, default=8,
                    help="fedbuff: updates per server merge")
    ap.add_argument("--staleness-exp", type=float, default=0.5,
                    help="fedbuff: weight *= (1+staleness)^-exp")
    ap.add_argument("--straggler-mode", default="drop",
                    choices=["drop", "downweight"])
    ap.add_argument("--staleness-cap", type=int, default=None,
                    help="fedbuff admission: reject updates staler than "
                         "this many server versions")
    ap.add_argument("--staleness-mode", default="drop",
                    choices=["drop", "requeue"],
                    help="what to do with a cap-rejected update: discard "
                         "it, or retrain its minibatches on the current "
                         "model")
    ap.add_argument("--max-inflight", type=int, default=None,
                    help="fedbuff: cap concurrent dispatched clients "
                         "(participation throttle; waiters join a FIFO)")
    ap.add_argument("--no-pool", action="store_true",
                    help="train each client in turn instead of one "
                         "vmapped call per width bucket")
    # ---- hierarchical multi-cell topology
    ap.add_argument("--topology", default="flat", choices=["flat", "hier"],
                    help="flat = the paper's single cell; hier = "
                         "client->edge->cloud with per-cell wireless, "
                         "streaming edge aggregation and a modelled "
                         "backhaul")
    ap.add_argument("--cells", type=int, default=4,
                    help="number of edge cells under --topology hier")
    ap.add_argument("--cell-assignment", default="contiguous",
                    choices=["contiguous", "round_robin"],
                    help="device->cell mapping")
    ap.add_argument("--cell-radius-scale", type=float, default=None,
                    help="per-cell radius as a fraction of the macro "
                         "cell's (default: 1/sqrt(cells), area tiling)")
    ap.add_argument("--cell-deadline", type=float, default=None,
                    help="per-cell edge deadline in seconds (the edge "
                         "ships its partial then; late arrivals drop)")
    ap.add_argument("--backhaul-rate", type=float, default=1e9,
                    help="edge->cloud backhaul throughput in bit/s")
    ap.add_argument("--backhaul-latency", type=float, default=0.01,
                    help="edge->cloud one-way latency in seconds")
    ap.add_argument("--backhaul-energy", type=float, default=0.0,
                    help="edge->cloud energy tariff in J/bit")
    ap.add_argument("--backhaul-codec", default="f32",
                    choices=["f32", "bf16", "int8"],
                    help="wire dtype of the shipped (num, den) partial")
    ap.add_argument("--backhaul-ef", action="store_true",
                    help="feed each round's bf16/int8 backhaul "
                         "quantization error back into the next round's "
                         "shipped partial (per-cell residual)")
    ap.add_argument("--backhaul-rate-range", type=float, nargs=2,
                    default=None, metavar=("LO", "HI"),
                    help="heterogeneous backhaul: draw each cell's rate "
                         "log-uniformly from [LO, HI] bit/s (seeded per "
                         "cell id; overrides --backhaul-rate)")
    ap.add_argument("--agg-route", default="streaming",
                    choices=["streaming", "batched"],
                    help="hierarchical aggregation route: the streaming "
                         "edge fold, or the batched (I, N) Eq. 5")
    # ---- mobility and handover
    ap.add_argument("--mobility", default="static",
                    choices=["static", "random_waypoint", "gauss_markov",
                             "replay"],
                    help="device motion model (static = the paper's "
                         "per-round position re-drop)")
    ap.add_argument("--speed", type=float, default=5.0,
                    help="mean device speed in m/s (random_waypoint "
                         "draws U[0.5x, 1.5x]; gauss_markov reverts to "
                         "this mean)")
    ap.add_argument("--mobility-seed", type=int, default=None,
                    help="motion-model seed (default: --seed)")
    ap.add_argument("--handover-policy", default="nearest",
                    choices=["none", "nearest", "load_balanced"],
                    help="round-boundary device->cell re-assignment of a "
                         "mobile hierarchy (none: devices keep their "
                         "initial cell)")
    ap.add_argument("--handover-margin", type=float, default=25.0,
                    help="handover hysteresis margin in metres")
    ap.add_argument("--scenario-trace", default=None,
                    help="JSON scenario for --mobility replay: device "
                         "waypoints, availability intervals and per-cell "
                         "backhaul rates over time (also feeds "
                         "--availability replay when no --trace-file is "
                         "given)")
    # ---- fleet dynamics
    ap.add_argument("--availability", default="always",
                    choices=["always", "markov", "diurnal", "replay"],
                    help="device availability trace (always = the "
                         "paper's static fleet)")
    ap.add_argument("--availability-seed", type=int, default=None,
                    help="trace seed (default: --seed)")
    ap.add_argument("--trace-file", default=None,
                    help="JSON on-intervals for --availability replay")
    ap.add_argument("--battery", default="off", choices=["off", "on"],
                    help="per-device state of charge: dispatches drain "
                         "E_cmp + E_com, headroom clamps E_max")
    ap.add_argument("--battery-capacity", type=float, default=60.0,
                    help="battery capacity in joules")
    ap.add_argument("--battery-recharge", type=float, default=0.05,
                    help="trickle recharge in joules per simulated second")
    ap.add_argument("--soc-deadline-scale", type=float, default=None,
                    help="shrink the T_max handed to the P4 solver by "
                         "this factor while the fleet's mean state of "
                         "charge is below --soc-deadline-threshold")
    ap.add_argument("--soc-deadline-threshold", type=float, default=0.5,
                    help="mean state-of-charge fraction below which the "
                         "deadline shrinks")
    ap.add_argument("--selection", default="uniform",
                    choices=["uniform", "energy", "gain", "oort"],
                    help="client-selection policy")
    ap.add_argument("--participation", type=float, default=1.0,
                    help="per-round cap as a fraction of the available "
                         "devices")
    ap.add_argument("--selection-seed", type=int, default=None,
                    help="seed of the selection generator (default: "
                         "--seed, through a generator of its own)")
    # ---- telemetry
    ap.add_argument("--telemetry-dir", default=None,
                    help="write the telemetry bundle here: "
                         "trace.perfetto.json (load in ui.perfetto.dev), "
                         "trace.jsonl, metrics.jsonl, manifest.json. Off "
                         "by default; on or off, the run's result is the "
                         "same bit for bit")
    ap.add_argument("--torch-profile", action="store_true",
                    help="also run under torch.profiler (a Chrome trace "
                         "of host ops and CUDA kernels under "
                         "<telemetry-dir>/torch_profile)")
    ap.add_argument("--health", action="store_true",
                    help="attach the health engine (needs "
                         "--telemetry-dir): rule-based detectors over the "
                         "learning.* / round.* series emit ALERT trace "
                         "instants, an alerts.jsonl in the bundle and a "
                         "[health] table")
    ap.add_argument("--health-rules", default=None,
                    help="JSON rule file overriding the default health "
                         "detectors (schema in telemetry/health.py)")
    ap.add_argument("--telemetry-rollup", type=int, default=None,
                    metavar="N",
                    help="fleet size at which device-labeled metrics fold "
                         "into bounded per-cell quantile sketches and "
                         "top-K trackers; below N, or without the flag, "
                         "the exact per-device cells")
    ap.add_argument("--trace-sample", type=float, default=None,
                    metavar="RATE",
                    help="keep only this fraction of device/<id> trace "
                         "rows, chosen by the deterministic hash "
                         "blake2b(seed, device_id) < RATE")
    args = ap.parse_args(argv)
    run_cfg = FLRunConfig(arch=args.arch, method=args.method,
                          rounds=args.rounds, seed=args.seed,
                          iid=not args.non_iid, n_train=args.n_train,
                          n_test=args.n_test, eval_every=args.eval_every)
    fleet = FleetConfig(n_devices=args.devices,
                        dynamics=_dynamics_config(args),
                        topology=_topology_config(args),
                        mobility=_mobility_config(args))
    orch = OrchestratorConfig(
        policy=args.async_mode, max_wallclock_s=args.max_wallclock,
        deadline_s=args.deadline, buffer_size=args.buffer_size,
        staleness_exponent=args.staleness_exp,
        staleness_cap=args.staleness_cap,
        staleness_mode=args.staleness_mode,
        straggler_mode=args.straggler_mode,
        max_inflight=args.max_inflight, agg_route=args.agg_route,
        use_pool=False if args.no_pool else None)
    if args.torch_profile and not args.telemetry_dir:
        raise SystemExit("--torch-profile needs --telemetry-dir: the "
                         "profile is written under "
                         "<telemetry-dir>/torch_profile")
    tel = NULL_TELEMETRY
    if args.telemetry_dir:
        rollup = None
        if args.telemetry_rollup is not None:
            rollup = RollupPolicy(device_threshold=args.telemetry_rollup,
                                  seed=args.seed)
        tel = Telemetry(args.telemetry_dir,
                        torch_profile=args.torch_profile, rollup=rollup,
                        trace_sample=args.trace_sample,
                        trace_seed=args.seed)
    if args.health:
        if not tel.enabled:
            raise SystemExit("--health needs --telemetry-dir: the health "
                             "engine evaluates the learning.* series a "
                             "telemetry session records")
        rules = load_rules(args.health_rules) if args.health_rules \
            else DEFAULT_RULES
        tel.health = HealthEngine(rules)
    hist = run_orchestrated(run_cfg, fleet, orch, device=args.device,
                            verbose=True, telemetry=tel)
    tta = {f"acc>={th:.2f}": hist.time_to_acc(th)
           for th in (0.3, 0.5, 0.7, 0.9) if hist.best_acc >= th}
    print(json.dumps({"arch": args.arch, "method": args.method,
                      "policy": args.async_mode,
                      "availability": args.availability,
                      "selection": args.selection,
                      "topology": args.topology,
                      "cells": args.cells if args.topology == "hier" else 1,
                      "mobility": args.mobility,
                      "handover_policy": args.handover_policy,
                      "n_handovers": hist.total_handovers(),
                      "best_acc": hist.best_acc,
                      "sim_wallclock_s": hist.wallclock(),
                      "backhaul_mb": float(sum(r.backhaul_bits
                                               for r in hist.rounds) / 8e6),
                      "time_to_acc_s": tta,
                      "rows": hist.to_rows()[-1]}, indent=1))
    # per-phase cost attribution (always available: the registry backs
    # every RoundLog whether or not a telemetry dir was given)
    totals = hist.phase_totals()
    print("[cost attribution]")
    print(f"  {'phase':>9s} {'energy_j':>12s} {'latency_s':>12s} "
          f"{'comm_mb':>12s}")
    for phase in PHASES:
        print(f"  {phase:>9s} {totals['energy_j'][phase]:12.3f} "
              f"{totals['latency_s'][phase]:12.3f} "
              f"{totals['comm_bits'][phase] / 8e6:12.3f}")
    if tel.enabled:
        if tel.health is not None:
            for line in tel.health.summary_table():
                print(line)
        manifest = build_manifest(
            run_cfg, fleet, orch, trace_signature=hist.trace,
            device=args.device,
            extra={"phase_totals": totals, "best_acc": hist.best_acc,
                   "n_alerts": (len(tel.health.alerts())
                                if tel.health is not None else None)})
        paths = tel.flush(manifest=manifest)
        for kind, path in sorted(paths.items()):
            print(f"[telemetry] {kind}: {path}")
    return hist


if __name__ == "__main__":
    main()
