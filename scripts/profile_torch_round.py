"""Where one synchronous round of the PyTorch port spends its time, on a card.

  python3 scripts/profile_torch_round.py [--devices 12] [--n-train 1536] \
      [--pool] [--async-mode semisync [--deadline S]]

Builds the main path's Simulation on ``cuda`` (fmnist-cnn at full width,
planner on), runs one warm-up round (it fits the beta planner and
builds the kernels), times one round unprofiled, then profiles one more
with ``torch.profiler`` (CPU and CUDA activities).  ``--pool`` trains
each width bucket in one vmapped call (``ClientPool.train_shared``, the
``train_shared`` phase) in place of one client at a time (``train_one``);
``--async-mode semisync`` runs the semisync policy (deadline: the
fleet's ``T_max`` unless ``--deadline``), which takes the pool unless
told otherwise, as in the reference.  The defaults are the reference's:
the sync policy, one client at a time.  Prints, on the host clock, both
rounds' wall times and each phase's share (the Simulation's methods and
the pool's ``train_shared``, wrapped in ``record_function`` here and not
in the package);
on the device, the summed kernel time, the device's idle share of the
round, and the kernels that took the most device time.  Needs one card;
imports no JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

PHASES = ("sort_params", "ensure_planner", "prepare", "train_one",
          "train_shared", "materialize", "aggregate", "evaluate")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=12)
    ap.add_argument("--n-train", type=int, default=1536)
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--pool", action="store_true",
                    help="train each width bucket in one vmapped call")
    ap.add_argument("--async-mode", default="sync",
                    choices=["sync", "semisync"])
    ap.add_argument("--deadline", type=float, default=None,
                    help="semisync cutoff in seconds (default: fleet T_max)")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.orchestrator import runner
    from repro_torch.orchestrator.policies import (OrchestratorConfig,
                                                   make_policy)
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig

    if not torch.cuda.is_available():
        sys.exit("profile_torch_round: needs a CUDA card")
    cfg = FLRunConfig(rounds=1, n_train=args.n_train, n_test=384,
                      eval_every=1, seed=0, use_planner=True)
    sim = runner.Simulation(cfg, FleetConfig(n_devices=args.devices),
                            device="cuda")
    for name in PHASES:
        owner = sim.pool if name == "train_shared" else sim
        fn = getattr(owner, name)

        def timed(*a, _fn=fn, _name=name, **k):
            with record_function(f"phase::{_name}"):
                return _fn(*a, **k)

        setattr(owner, name, timed)
    orch = OrchestratorConfig(policy=args.async_mode,
                              deadline_s=args.deadline,
                              use_pool=True if args.pool else None)
    policy = make_policy(orch, fleet_T_max=sim.fleet_cfg.T_max)
    runner._run_round_based(sim, policy, orch, False)      # warm-up round
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner._run_round_based(sim, policy, orch, False)
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner._run_round_based(sim, policy, orch, False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)

    # a phase appears twice, as the host range and as its device-side
    # annotation; the host range carries the host time
    phases = {}
    for e in events:
        if e.key.startswith("phase::"):
            name = e.key[len("phase::"):]
            phases[name] = phases.get(name, 0.0) + e.cpu_time_total / 1e3
    # device work only: kernels, copies and sets run on the CUDA device;
    # the aten ops that launched them carry the same time again
    kernels = sorted((e for e in events
                      if e.device_type == DeviceType.CUDA and dev_us(e) > 0
                      and not e.key.startswith("phase::")),
                     key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    pooled = orch.use_pool if orch.use_pool is not None \
        else policy.pool_default
    print(f"{args.async_mode}, {'pooled' if pooled else 'one client at a time'}: "
          f"round wall {plain_wall_ms:.3f} ms unprofiled, {wall_ms:.3f} ms "
          f"profiled (host clock, synchronised); "
          f"device kernel time {busy_ms:.3f} ms; device idle share "
          f"{1.0 - busy_ms / wall_ms:.4f}")
    for name in PHASES:
        if name in phases:
            print(f"  phase {name:15s} {phases[name]:10.3f} ms host "
                  f"({phases[name] / wall_ms:.4f} of the round)")
    print(f"top {args.top} device kernels by device time:")
    for e in kernels[:args.top]:
        print(f"  {dev_us(e) / 1e3:9.3f} ms  {e.count:6d} calls  "
              f"{e.key[:90]}")
    print(json.dumps({
        "round_wall_ms": wall_ms, "unprofiled_round_wall_ms": plain_wall_ms,
        "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / wall_ms,
        "phases_host_ms": phases,
        "top_device_ms": {e.key[:90]: dev_us(e) / 1e3
                          for e in kernels[:args.top]},
        "policy": args.async_mode, "pool": pooled,
        "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
