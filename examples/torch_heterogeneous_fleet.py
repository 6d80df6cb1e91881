"""Heterogeneous-fleet comparison on the PyTorch port: AnycostFL vs STC
vs HeteroFL over the simulated wireless cell (the paper's §V setting,
reduced scale), on the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_heterogeneous_fleet.py [rounds]
      [--device cpu] [--devices N] [--n-train N]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.sysmodel.population import FleetConfig
from repro_torch.train.fl_loop import FLRunConfig, run_fl

ap = argparse.ArgumentParser()
ap.add_argument("rounds", nargs="?", type=int, default=12)
ap.add_argument("--device", default="cuda")
ap.add_argument("--devices", type=int, default=8)
ap.add_argument("--n-train", type=int, default=768)
args = ap.parse_args()
fleet = FleetConfig(n_devices=args.devices)

results = {}
for method in ("anycostfl", "stc", "heterofl"):
    cfg = FLRunConfig(method=method, rounds=args.rounds,
                      n_train=args.n_train, n_test=256, eval_every=3,
                      lr=0.1)
    hist = run_fl(cfg, fleet, device=args.device, verbose=True)
    results[method] = hist

print("\nmethod        best_acc  total_time(s)  total_energy(J)  comm(MB)")
for method, hist in results.items():
    t = hist.cumulative("latency_s")[-1]
    e = hist.cumulative("energy_j")[-1]
    c = hist.cumulative("comm_bits")[-1] / 8e6
    print(f"{method:12s}  {hist.best_acc:.4f}    {t:10.1f}    {e:12.1f}  "
          f"{c:8.2f}")
