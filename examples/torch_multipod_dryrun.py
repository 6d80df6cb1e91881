"""Drive the PyTorch port's production dry-run for one architecture and
print its roofline: ``python -m repro_torch.launch.dryrun`` on the single-
and the multi-pod mesh, each in a subprocess of its own (a fake process
group of 256 or 512 ranks is process-wide), results read back from
``experiments/dryrun_torch/``.

The traces run on ``meta`` tensors either way; like every example of the
port it asks for the card unless ``--device cpu`` is given.

  PYTHONPATH=src python examples/torch_multipod_dryrun.py [arch] [shape]
      [--device cpu]
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.device import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("arch", nargs="?", default="qwen2-7b")
ap.add_argument("shape", nargs="?", default="train_4k")
ap.add_argument("--device", default="cuda")
args = ap.parse_args()
resolve_device(args.device)
arch, shape = args.arch, args.shape

for mesh in ("single", "multi"):
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    print(f"$ {' '.join(cmd[1:])}")
    out = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                         text=True)
    print(out.stdout.strip().splitlines()[-1] if out.stdout else out.stderr)
    path = os.path.join(ROOT, "experiments", "dryrun_torch",
                        f"{arch}__{shape}__{mesh}__baseline.json")
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("skipped"):
            continue
        r = rec["roofline"]
        print(f"  mesh={rec['mesh_desc']}  bottleneck={r['bottleneck']}  "
              f"compute={r['t_compute']:.3e}s memory={r['t_memory']:.3e}s "
              f"collective={r['t_collective']:.3e}s  "
              f"useful={r['useful_ratio']:.2f}")
        print(f"  memory_analysis: {rec['memory_analysis']}")
