"""Async fleet demo on the PyTorch port: the same heterogeneous cell
under three server policies — lock-step rounds, a semi-sync deadline
that drops stragglers, and FedBuff-style buffered fully-async
aggregation — on the card unless ``--device cpu`` is given.

The x-axis here is *simulated wall-clock*, not round index: fedbuff keeps
every device busy (fast devices contribute more merges), while semisync
caps each round at the T_max deadline.

  PYTHONPATH=src python examples/torch_async_fleet.py [sim_seconds]
      [--device cpu] [--rounds R] [--devices N] [--n-train N]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.orchestrator.policies import OrchestratorConfig
from repro_torch.orchestrator.runner import run_orchestrated
from repro_torch.sysmodel.population import FleetConfig
from repro_torch.train.fl_loop import FLRunConfig

ap = argparse.ArgumentParser()
ap.add_argument("sim_seconds", nargs="?", type=float, default=80.0)
ap.add_argument("--device", default="cuda")
ap.add_argument("--rounds", type=int, default=8)
ap.add_argument("--devices", type=int, default=8)
ap.add_argument("--n-train", type=int, default=768)
args = ap.parse_args()
sim_seconds = args.sim_seconds
fleet = FleetConfig(n_devices=args.devices)
run_cfg = FLRunConfig(method="anycostfl", rounds=args.rounds,
                      n_train=args.n_train, n_test=256, eval_every=2,
                      lr=0.1)

policies = {
    "sync": OrchestratorConfig(policy="sync",
                               max_wallclock_s=sim_seconds),
    "semisync": OrchestratorConfig(policy="semisync",
                                   straggler_mode="drop",
                                   max_wallclock_s=sim_seconds),
    "fedbuff": OrchestratorConfig(policy="fedbuff", buffer_size=4,
                                  max_wallclock_s=sim_seconds),
}

results = {}
for name, orch in policies.items():
    print(f"--- {name} ---")
    results[name] = run_orchestrated(run_cfg, fleet, orch,
                                     device=args.device, verbose=True)

print("\npolicy      best_acc  sim_time(s)  merges  energy(J)  "
      "mean_staleness")
for name, hist in results.items():
    e = hist.cumulative("energy_j")[-1]
    stale = sum(r.mean_staleness for r in hist.rounds) / max(
        len(hist.rounds), 1)
    print(f"{name:10s}  {hist.best_acc:.4f}   {hist.wallclock():9.1f}  "
          f"{len(hist.rounds):6d}  {e:9.1f}  {stale:8.2f}")
