"""Time one width group of the client pool's vmapped step on the card,
before and after ``models/cnn_lanes``.

  python3 scripts/pool_step_layouts.py
      [--out chiprun_out/pool_step_layouts.json]

Runs ``AnycostClient._local_steps_batched`` for both CNNs (VGG-9 on
CIFAR, the benchmark cell's model, and the FMNIST CNN) at the widths
0.25, 0.4 and 1.0: one group of 20 clients that start from one shrunk
model (``shared=True``, as ``ClientPool.train_shared`` does), 26 steps
of 32 uniform random images, the cell's shapes, in two variants:

* ``vmap_grad``: vmap's per-op batching of the model's own forward (the
  path before ``models/cnn_lanes``: cuDNN's grouped convolutions);
* ``lanes``: ``models/cnn_lanes.lane_grad``, what the pool runs.

Per variant and width: the host's time to enqueue a step (the clock
around the group's call, before the closing synchronize), the wall time
a step (to the synchronize), the device's busy time a step (the sum of
the profiler's kernel times over one more group), its five largest
kernels, the aten operations a step (one step counted under a
``TorchDispatchMode``), the peak memory above what the group's inputs
hold, ``cnn_lanes.lane_bytes``' estimate for the group less its
minibatches, and the largest relative difference of two steps'
parameters from ``vmap_grad``'s (by leaf, over the leaf's largest
magnitude; a max-pool near-tie that routes a lane's gradient elsewhere
reads 1e-3-1e-1).  Prints a table and writes it as JSON to ``--out``
with the card's name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

MODELS = ("vgg9-cifar", "fmnist-cnn")
WIDTHS = (0.25, 0.4, 1.0)
LANES, BATCH, STEPS, REPS = 20, 32, 26, 5
VARIANTS = ("vmap_grad", "lanes")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else "nvidia-smi failed"


def variant(name: str, model):
    """The pool's step as ``name`` runs it."""
    import unittest.mock

    import torch

    from repro_torch.core import anycost
    if name == "lanes":
        return contextlib.nullcontext()
    return unittest.mock.patch.object(
        anycost.cnn_lanes, "lane_grad", lambda loss: torch.func.grad(
            lambda q, batch: anycost.loss_fn(model, q, batch)))


def count_ops(fn) -> int:
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def measure(client, sub, batches) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.utils.pytree import tree_leaves

    def group():
        return client._local_steps_batched(sub, batches, shared=True)

    gc.collect()                              # as the benchmark's window
    gc.freeze()
    group()                                   # warm-up, cuDNN's choices
    torch.cuda.synchronize()
    one = {k: v[:, :1] for k, v in batches.items()}
    first = tree_leaves(client._local_steps_batched(
        sub, {k: v[:, :2] for k, v in batches.items()}, shared=True))
    ops = count_ops(lambda: client._local_steps_batched(sub, one,
                                                        shared=True))
    host, wall = [], []
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for _ in range(REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = group()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / STEPS * 1e3)
        wall.append((t2 - t0) / STEPS * 1e3)
        del out
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        group()
        torch.cuda.synchronize()
    # the device's kernels, not the spans' ranges on its timeline
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.key.startswith("train")]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3 / STEPS
    top = [(e.key[:60], round(e.self_device_time_total / 1e3 / STEPS, 4),
            e.count // STEPS)
           for e in sorted(kernels, key=lambda e:
                           -e.self_device_time_total)[:5]]
    return {"host_ms": sorted(host)[len(host) // 2],
            "wall_ms": sorted(wall)[len(wall) // 2],
            "busy_ms": busy, "top5": top, "ops": ops, "peak_mib": peak,
            "first": first}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out",
                    default=os.path.join("chiprun_out",
                                         "pool_step_layouts.json"))
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import shrinking
    from repro_torch.core.anycost import AnycostClient
    from repro_torch.device import resolve_device
    from repro_torch.models import cnn, cnn_lanes
    from repro_torch.models.registry import build_model

    dev = resolve_device("cuda")
    where = card()
    print(f"# {where}; torch {torch.__version__}", flush=True)
    rows = []
    for model_name in MODELS:
        cfg = get_config(model_name)
        model, spec = build_model(cfg), shrinking.cnn_shrink_spec(cfg)
        client = AnycostClient(model, spec, lr=0.05, batch_size=BATCH)
        gen = torch.Generator(device=dev).manual_seed(0)
        params = shrinking.sort_channels(model.init(
            torch.Generator().manual_seed(0), dev), spec)
        batches = {
            "images": torch.rand(LANES, STEPS, BATCH, *cnn.image_shape(cfg),
                                 generator=gen, device=dev),
            "labels": torch.randint(0, cfg.vocab_size, (LANES, STEPS, BATCH),
                                    generator=gen, device=dev)}
        for alpha in WIDTHS:
            sub = shrinking.shrink(params, alpha, spec)
            # the estimate less the lane's minibatches, which `base` holds
            lane = cnn_lanes.lane_bytes(sub, batches["images"][0]) \
                - batches["images"][0].nbytes - batches["labels"][0].nbytes
            want = None
            for name in VARIANTS:
                with variant(name, model):
                    r = measure(client, sub, batches)
                first = r.pop("first")
                if want is None:
                    want = first
                r["rel_diff"] = max(
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(first, want))
                r.update(model=model_name, width=alpha, variant=name,
                         lane_bytes_mib=LANES * lane / 2**20)
                rows.append(r)
                print(json.dumps(r), flush=True)
    print(f"\n{'model':<11} {'width':>5} {'variant':<10} {'host ms':>8} "
          f"{'wall ms':>8} {'busy ms':>8} {'ops':>5} {'peak MiB':>9} "
          f"{'est MiB':>8} {'rel diff':>9}")
    for r in rows:
        print(f"{r['model']:<11} {r['width']:>5} {r['variant']:<10} "
              f"{r['host_ms']:>8.3f} {r['wall_ms']:>8.3f} "
              f"{r['busy_ms']:>8.3f} {r['ops']:>5} {r['peak_mib']:>9.0f} "
              f"{r['lane_bytes_mib']:>8.0f} {r['rel_diff']:>9.2e}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": where, "torch": torch.__version__,
                   "lanes": LANES, "batch": BATCH, "steps": STEPS,
                   "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
