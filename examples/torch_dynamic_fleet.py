"""Fleet dynamics demo on the PyTorch port: churn, draining batteries,
gain-aware selection.

Runs the same tiny AnycostFL workload over (a) the paper's static
always-on roster and (b) a dynamic fleet — 2-state Markov availability,
a battery model whose headroom clamps each device's per-round ``E_max``,
and gain-aware selection under a 50% participation cap — then prints a
per-round comparison of who actually trained.  On the card unless
``--device cpu`` is given.

``PYTHONPATH=src python examples/torch_dynamic_fleet.py [--device cpu]
[--rounds R] [--devices N] [--n-train N]``
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.fleet import (AvailabilityConfig, BatteryConfig,
                               FleetDynamicsConfig)
from repro_torch.orchestrator.policies import OrchestratorConfig
from repro_torch.orchestrator.runner import run_orchestrated
from repro_torch.sysmodel.population import FleetConfig
from repro_torch.train.fl_loop import FLRunConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--n-train", type=int, default=512)
    args = ap.parse_args()
    run_cfg = FLRunConfig(method="anycostfl", rounds=args.rounds,
                          n_train=args.n_train, n_test=128, eval_every=2,
                          lr=0.1, seed=0, use_planner=False)
    orch = OrchestratorConfig(policy="sync")

    static = run_orchestrated(run_cfg, FleetConfig(n_devices=args.devices),
                              orch, device=args.device)

    dyn = FleetDynamicsConfig(
        availability=AvailabilityConfig(kind="markov", seed=0,
                                        mean_on_s=30.0, mean_off_s=15.0),
        battery=BatteryConfig(capacity_j=30.0, recharge_w=0.2, seed=0),
        selection="gain", participation=0.5)
    dynamic = run_orchestrated(
        run_cfg, FleetConfig(n_devices=args.devices, dynamics=dyn), orch,
        device=args.device)

    print(f"{'round':>5} {'static':>8} {'dynamic':>8} {'off':>4} "
          f"{'aborted':>8} {'soc':>6}")
    for s, d in zip(static.rounds, dynamic.rounds):
        print(f"{s.round:>5} {s.n_clients:>8} {d.n_clients:>8} "
              f"{d.n_unavailable:>4} {d.n_aborted:>8} {d.mean_soc:>6.2f}")
    print(f"static : acc={static.best_acc:.3f} "
          f"E={static.cumulative('energy_j')[-1]:.1f}J")
    print(f"dynamic: acc={dynamic.best_acc:.3f} "
          f"E={dynamic.cumulative('energy_j')[-1]:.1f}J "
          f"({len(dynamic.dispatch_log)} dispatches)")


if __name__ == "__main__":
    main()
