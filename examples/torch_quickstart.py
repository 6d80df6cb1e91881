"""Quickstart on the PyTorch port: one AnycostFL round, end to end.

Three heterogeneous devices train width-shrunk sub-models, FGC-compress
their updates, and the server AIO-aggregates with Theorem-1 weights, on
the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
      [--devices N] [--n-train N]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import schedule, shrinking
from repro_torch.core.anycost import AnycostClient, AnycostServer
from repro_torch.data.synthetic import make_image_task
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.sysmodel.population import FleetConfig, make_fleet
from repro_torch.train.fl_loop import flops_per_sample
from repro_torch.utils.pytree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--devices", type=int, default=3)
ap.add_argument("--n-train", type=int, default=512)
args = ap.parse_args()
dev = resolve_device(args.device)

rng = np.random.default_rng(0)
cfg = get_config("fmnist-cnn")
model = build_model(cfg)
spec = shrinking.cnn_shrink_spec(cfg)
n_train = args.n_train
train, test = make_image_task(rng, n_train, 256, shape=(28, 28, 1))

params = model.init(torch.Generator().manual_seed(0), dev)
client = AnycostClient(model, spec, lr=0.1, batch_size=64)
server = AnycostServer(model, spec)
n_params = sum(x.numel() for x in tree_leaves(params))

# heterogeneous devices with very different budgets solve their own
# Problem (P4)
fleet = make_fleet(rng, FleetConfig(n_devices=args.devices),
                   np.resize(np.array([170, 170, 172]), args.devices))
envs = fleet.round_envs(rng, W=flops_per_sample(cfg),
                        S_bits=32.0 * n_params)

sorted_params = server.sort(params)           # EMS channel sorting
updates = []
gen = torch.Generator(device=dev).manual_seed(1)
for i, env in enumerate(envs):
    strat = schedule.solve(env)               # closed-form Eq. 23-26
    print(f"device {i}: alpha={strat.alpha:.2f} beta={strat.beta:.4f} "
          f"f={strat.freq / 1e9:.2f}GHz gain={strat.gain:.4f} "
          f"(T={strat.T_cmp + strat.T_com:.1f}s/{env.T_max}s "
          f"E={strat.E_cmp + strat.E_com:.1f}J/{env.E_max:.1f}J)"
          + ("" if strat.feasible else "  -> infeasible, sits out"))
    if not strat.feasible:    # deep fade / tiny budget: client selection
        continue
    idx = rng.integers(0, n_train, (3, 64))
    batches = {"images": torch.from_numpy(train.x[idx]).to(dev),
               "labels": torch.from_numpy(train.y[idx]).to(dev)}
    updates.append(client.local_round(sorted_params, strat, batches, gen))

params = server.aggregate(sorted_params, updates)  # AIO + Theorem-1 p*

with torch.no_grad():
    logits = model.forward(params, {"images": torch.from_numpy(test.x)
                                    .to(dev)})
acc = float((logits.argmax(-1).cpu() == torch.from_numpy(test.y))
            .float().mean())
print(f"after 1 round: test acc {acc:.3f}, "
      f"uplink {sum(u.bits for u in updates) / 8e6:.2f} MB "
      f"(vs {args.devices * 32 * n_params / 8e6:.2f} MB uncompressed)")
