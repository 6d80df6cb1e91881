"""Anycost serving (Fig. 5d) on the PyTorch port: one trained model, many
deployment widths, on the card unless ``--device cpu`` is given.

Trains the paper's CNN federatedly for a few rounds, then slices alpha
sub-models and reports their test accuracy WITHOUT retraining; then shows
the same EMS machinery slicing a transformer LM for width-elastic serving
(the launch/serve.py path).

  PYTHONPATH=src python examples/torch_anycost_serving.py [--device cpu]
      [--rounds R] [--n-train N]
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
from repro_torch.utils.pytree import tree_leaves

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
ap.add_argument("--rounds", type=int, default=10)
ap.add_argument("--n-train", type=int, default=1024)
args = ap.parse_args()
dev = resolve_device(args.device)

rng = np.random.default_rng(0)
cfg = get_config("fmnist-cnn")
model = build_model(cfg)
spec = shrinking.cnn_shrink_spec(cfg)
train, test = make_image_task(rng, args.n_train, 512, shape=(28, 28, 1))
params = model.init(torch.Generator().manual_seed(0), dev)
client = AnycostClient(model, spec, lr=0.1, batch_size=64)
server = AnycostServer(model, spec)

strategies = [schedule.Strategy(a, b, 1e9, 0.5, 0.5, a ** 4 * b,
                                1, 1, 1, 1, True)
              for a, b in ((1.0, 0.06), (0.7, 0.05), (0.4, 0.04))]
gen = torch.Generator(device=dev).manual_seed(1)
for r in range(args.rounds):
    sorted_p = server.sort(params)
    updates = []
    for strat in strategies:
        idx = rng.integers(0, args.n_train, (5, 64))
        batches = {"images": torch.from_numpy(train.x[idx]).to(dev),
                   "labels": torch.from_numpy(train.y[idx]).to(dev)}
        updates.append(client.local_round(sorted_p, strat, batches, gen))
    params = server.aggregate(sorted_p, updates)

print("width  params%  test-acc (no retraining)")
sorted_p = server.sort(params)
tx, ty = torch.from_numpy(test.x).to(dev), np.asarray(test.y)
for alpha in (1.0, 0.7, 0.55, 0.4, 0.25):
    sub = shrinking.shrink(sorted_p, alpha, spec)
    frac = shrinking.effective_alpha(spec, alpha, sorted_p)
    with torch.no_grad():
        logits = model.forward(sub, {"images": tx})
    acc = float(np.mean(logits.argmax(-1).cpu().numpy() == ty))
    print(f"{alpha:5.2f}  {frac:6.1%}  {acc:.4f}")

# ---- the same machinery on a transformer LM (serving path)
print("\ntransformer width-elastic serving (qwen2 reduced):")
lm_cfg = get_config("qwen2-7b").reduced()
lm = build_model(lm_cfg)
lm_params = lm.init(torch.Generator().manual_seed(2), dev)
lm_spec = shrinking.transformer_shrink_spec(lm_cfg, lm_params)
toks = torch.randint(0, lm_cfg.vocab_size, (2, 16),
                     generator=torch.Generator().manual_seed(3)).to(dev)
for alpha in (1.0, 0.5, 0.25):
    sub_cfg = shrinking.shrunk_config(lm_cfg, alpha, lm_spec)
    sub = shrinking.shrink(shrinking.sort_channels(lm_params, lm_spec),
                           alpha, lm_spec)
    sub_lm = build_model(sub_cfg)
    with torch.no_grad():
        logits = sub_lm.forward(sub, {"tokens": toks}, remat="none")
    n = sum(x.numel() for x in tree_leaves(sub))
    print(f"alpha={alpha:.2f}: d_ff={sub_cfg.d_ff} heads={sub_cfg.n_heads} "
          f"params={n / 1e6:.2f}M logits finite="
          f"{bool(torch.isfinite(logits).all())}")
