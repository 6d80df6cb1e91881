"""How far a top-k baseline's run on the card strays from the CPU's.

  python3 scripts/topk_card_cpu_agreement.py [--seeds 10]

Runs ``chip_smoke.py`` phase 3's small QSGD and UVeQFed runs (3 devices,
2 rounds, fmnist-cnn at full width) on the card and on the CPU over
several seeds (run seed s, uniforms seed s + 4; phase 3 uses s = 3) and
prints, per run and round, ``chip_smoke.small_run_pair``'s readings
(the most elements in which one update's top-k masks differ, the most
kept level indices that differ, how near the CPU's threshold the
swapped elements lie, how far the two updates drift apart) and the test
loss's relative difference.  The last line gives the largest loss
difference in rounds before any mask differed and from the first such
round on, and round 0's largest readings: ``chip_smoke.py``'s
``TOPK_FIRST_SWAPS``, ``TOPK_FIRST_NEAR`` and ``TOPK_LOSS_RTOL`` are set
from them.
Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        chip_smoke.fail("this script needs a CUDA card")
    from repro_torch.kernels import build
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig

    build.build_all()
    print(chip_smoke.card_line(), flush=True)
    fleet = FleetConfig(n_devices=3)
    before, after = 0.0, 0.0
    first = dict(swaps=0, near=0.0, drift=0.0)
    for method in ("qsgd", "uveqfed"):
        for seed in range(args.seeds):
            cfg = FLRunConfig(rounds=2, n_train=128, n_test=64,
                              eval_every=1, lr=0.1, seed=seed,
                              use_planner=False, method=method)
            logs, diffs = chip_smoke.small_run_pair(cfg, fleet, seed + 4)
            swapped = False
            rows = []
            for c, g, d in zip(logs["cpu"], logs["cuda"], diffs):
                rel = abs(g.test_loss - c.test_loss) / abs(c.test_loss)
                swapped = swapped or d["swaps"] > 0
                if swapped:
                    after = max(after, rel)
                else:
                    before = max(before, rel)
                if c.round == 0:
                    first = {k: max(v, d[k]) for k, v in first.items()}
                rows.append(dict(round=c.round, **d, loss_cpu=c.test_loss,
                                 loss_card=g.test_loss, loss_rel=rel))
            print(json.dumps(dict(method=method, seed=seed, rounds=rows)),
                  flush=True)
    print(json.dumps(dict(seeds=args.seeds,
                          loss_rel_before_a_swap=before,
                          loss_rel_from_a_swap=after,
                          round_0=first)), flush=True)


if __name__ == "__main__":
    main()
