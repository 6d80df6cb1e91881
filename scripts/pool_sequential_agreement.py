"""How far the client pool's run drifts from the one-client-at-a-time run.

  python3 scripts/pool_sequential_agreement.py [--seeds 10] [--device cpu]

Runs the synchronous policy twice per seed through ``run_orchestrated``,
with ``use_pool=False`` and ``use_pool=True`` (fmnist-cnn at full width,
12 devices, 3 rounds, n_train 1536, the planner on, the default uniforms,
equal on both sides), and prints per round: whether the round's EMS
channel sort (the permutations ``shrinking.sort_channels`` takes from
the round-start parameters) is the same in both runs, the largest
relative difference of a client's realized bits, and the relative
difference of the test loss; for round 0, also how far each client's
trained sub-model lies from the other run's, as a share of the norm of
its update (``chip_smoke.py`` phase 7a holds it at ``POOL_LANE_RTOL``).
It records the runs with ``chip_smoke.py``'s helpers.  A vmapped
convolution sums in another order, so the two runs start apart by
float32 rounding; the sort is a discontinuity that can turn that into a
different sub-model for a device.  The last line is a JSON summary: the largest loss difference
in rounds whose sorts all agreed so far, and in rounds from the first
one whose sort differed, and round 0's largest bits difference and
parameter drift.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--devices", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import torch

    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.orchestrator.runner import run_orchestrated
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig

    where = (torch.cuda.get_device_name(0) if args.device == "cuda"
             else "cpu")
    from chip_smoke import lane_drift, recording_rounds, sort_perms

    same_sort = after_swap = first_bits = first_drift = 0.0
    for seed in range(args.seeds):
        cfg = FLRunConfig(rounds=args.rounds, n_train=1536, n_test=384,
                          eval_every=1, seed=seed, use_planner=True)
        runs = []
        for pool in (False, True):
            rounds, clients = [], []
            with recording_rounds(rounds, clients):
                hist = run_orchestrated(cfg, FleetConfig(
                    n_devices=args.devices), OrchestratorConfig(
                        use_pool=pool), device=args.device)
            runs.append((sort_perms(rounds), clients, hist.rounds))
        (p0, c0, r0), (p1, c1, r1) = runs
        swapped, at = False, 0
        for t, (a, b) in enumerate(zip(r0, r1)):
            n = a.n_clients + a.n_dropped
            pairs = list(zip(c0[at:at + n], c1[at:at + n]))
            at += n
            bits_rel = max((abs(x[1] - y[1]) / x[1] for x, y in pairs),
                           default=0.0)
            if t == 0:
                drift = max((lane_drift(y[3], x[3], y[4]) for x, y in pairs),
                            default=0.0)
                first_bits = max(first_bits, bits_rel)
                first_drift = max(first_drift, drift)
                print(f"seed {seed} round 0: trained parameters within "
                      f"{drift:.3e} of the update's norm", flush=True)
            swapped = swapped or p0[t] != p1[t]
            loss_rel = abs(a.test_loss - b.test_loss) / abs(a.test_loss)
            if swapped:
                after_swap = max(after_swap, loss_rel)
            else:
                same_sort = max(same_sort, loss_rel)
            print(f"seed {seed} round {t}: sort {'differs' if p0[t] != p1[t] else 'same'}; "
                  f"bits max rel {bits_rel:.3e}; test loss {a.test_loss} "
                  f"sequential, {b.test_loss} pooled, rel {loss_rel:.3e}",
                  flush=True)
    print(json.dumps({"device": where, "seeds": args.seeds,
                      "max_loss_rel_same_sort": same_sort,
                      "max_loss_rel_after_sort_differs": after_swap,
                      "round0_max_bits_rel": first_bits,
                      "round0_max_param_drift": first_drift}))


if __name__ == "__main__":
    main()
