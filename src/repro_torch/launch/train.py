"""FL training entry point: the paper's synchronous AnycostFL round.

  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \\
      --method anycostfl --rounds 40 --devices 12 [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given, and prints the
reference launcher's final JSON fields.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.sysmodel.population import FleetConfig
from repro_torch.train.fl_loop import FLRunConfig, run_fl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="fl", choices=["fl"])
    ap.add_argument("--method", default="anycostfl", choices=["anycostfl"])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--devices", type=int, default=12)
    ap.add_argument("--n-train", type=int, default=1536)
    ap.add_argument("--n-test", type=int, default=384)
    ap.add_argument("--eval-every", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    run_cfg = FLRunConfig(method=args.method, rounds=args.rounds,
                          seed=args.seed, n_train=args.n_train,
                          n_test=args.n_test, eval_every=args.eval_every)
    hist = run_fl(run_cfg, FleetConfig(n_devices=args.devices),
                  device=args.device, verbose=True)
    tta = {f"acc>={th:.2f}": hist.time_to_acc(th)
           for th in (0.3, 0.5, 0.7, 0.9) if hist.best_acc >= th}
    print(json.dumps({"method": args.method, "policy": "sync",
                      "availability": "always", "selection": "uniform",
                      "topology": "flat", "cells": 1, "mobility": "static",
                      "handover_policy": "nearest", "n_handovers": 0,
                      "best_acc": hist.best_acc,
                      "sim_wallclock_s": hist.wallclock(),
                      "backhaul_mb": 0.0,
                      "time_to_acc_s": tta,
                      "rows": hist.to_rows()[-1]}, indent=1))
    return hist


if __name__ == "__main__":
    main()
