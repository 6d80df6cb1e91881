"""Mobile-fleet walkthrough on the PyTorch port: motion, handover, and a
scenario trace, on the card unless ``--device cpu`` is given.

Three short demonstrations of the mobility subsystem:

1. the same AnycostFL workload over a 3-cell hierarchy with a *stale*
   cell binding (devices wander but keep their initial cell) versus
   nearest-site handover at round boundaries — watch the handover count
   and the per-round energy/latency;
2. load-balanced handover on a hotspot-skewed random-waypoint scenario
   — peak per-cell occupancy drops versus nearest;
3. a unified JSON scenario trace (positions + availability + per-cell
   backhaul rates) synthesized, saved, and replayed end to end.

``PYTHONPATH=src python examples/torch_mobile_fleet.py [--device cpu]
[--rounds R] [--devices N] [--n-train N]``
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.mobility import HandoverConfig, MobilityConfig, ScenarioTrace
from repro_torch.orchestrator.policies import OrchestratorConfig
from repro_torch.orchestrator.runner import run_orchestrated
from repro_torch.sysmodel.population import FleetConfig
from repro_torch.topology import BackhaulConfig, TopologyConfig, cell_sites
from repro_torch.train.fl_loop import FLRunConfig


def run(args, mobility=None, handover=None, cells=3):
    cfg = FLRunConfig(method="anycostfl", rounds=args.rounds,
                      n_train=args.n_train, n_test=128, eval_every=2,
                      lr=0.1, seed=0, use_planner=False)
    topo = TopologyConfig(kind="hier", n_cells=cells, handover=handover,
                          backhaul=BackhaulConfig(rate_bps=1e8,
                                                  latency_s=0.05))
    fleet = FleetConfig(n_devices=args.devices, topology=topo,
                        mobility=mobility)
    return run_orchestrated(cfg, fleet, OrchestratorConfig(policy="sync"),
                            device=args.device)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--devices", type=int, default=9)
    ap.add_argument("--n-train", type=int, default=512)
    args = ap.parse_args()
    mob = MobilityConfig(kind="random_waypoint", seed=7,
                         speed_range=(20.0, 40.0))

    print("== stale cells vs nearest handover (vehicular waypoints) ==")
    stale = run(args, mobility=mob)
    near = run(args, mobility=mob,
               handover=HandoverConfig(policy="nearest", margin_m=25.0))
    print(f"{'round':>5} {'stale_E':>8} {'near_E':>8} {'handover':>9} "
          f"{'occupancy':>10}")
    for a, b in zip(stale.rounds, near.rounds):
        print(f"{a.round:>5} {a.energy_j:>8.2f} {b.energy_j:>8.2f} "
              f"{b.n_handovers:>9} {b.max_cell_occupancy:>10}")
    print(f"stale  best_acc={stale.best_acc:.3f} handovers=0")
    print(f"near   best_acc={near.best_acc:.3f} "
          f"handovers={near.total_handovers()} "
          f"(re-homing keeps uplinks short as devices move)")

    print("\n== hotspot skew: nearest vs load-balanced handover ==")
    sites = cell_sites(3, 550.0)
    skew = MobilityConfig(kind="random_waypoint", seed=11,
                          speed_range=(20.0, 40.0),
                          hotspot=tuple(sites[0]), hotspot_frac=0.8,
                          hotspot_radius_m=120.0)
    nn = run(args, mobility=skew, handover=HandoverConfig(policy="nearest"))
    lb = run(args, mobility=skew, handover=HandoverConfig(
        policy="load_balanced", margin_m=150.0))
    print(f"nearest        peak occupancy "
          f"{max(r.max_cell_occupancy for r in nn.rounds)}")
    print(f"load_balanced  peak occupancy "
          f"{max(r.max_cell_occupancy for r in lb.rounds)}")

    print("\n== unified scenario trace: save, replay, compose ==")
    scen = ScenarioTrace(
        devices=[{"waypoints": [[0.0, -200.0, 0.0], [60.0, 200.0, 0.0]],
                  "on": [[0.0, 1e6]]} for _ in range(3)],
        cells=[{"site": sites[k].tolist(),
                "backhaul_bps": [[0.0, 1e8], [20.0, 2e7]]}
               for k in range(3)])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "scenario.json")
        scen.save(path)
        replay = run(args, mobility=MobilityConfig(kind="replay",
                                                   scenario_file=path),
                     handover=HandoverConfig(policy="nearest"))
    print(f"replayed scenario: best_acc={replay.best_acc:.3f} "
          f"handovers={replay.total_handovers()} "
          f"(one JSON file drove positions, availability, and the "
          f"per-cell backhaul rate step)")


if __name__ == "__main__":
    main()
