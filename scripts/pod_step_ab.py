"""Phases 12b, 12c and 13c of ``chip_smoke.py`` (the pod trainer's steps
at published widths, each followed by a step under ``torch.profiler``)
for several checkouts, one after another on the one card, each in a
process of its own: an A/B of two commits on the same card in one run.

    python3 scripts/pod_step_ab.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (its ``chip_smoke.py`` and
``src/``); list two commits as A B B A.  Every run builds its own
checkout's kernels.  Prints each run's lines of the three phases
prefixed with its root, then one JSON line a run: the median step ms
and, of the profiled step, host ms, kernel ms, device idle share,
top-level aten ops and device kernels.  Needs a CUDA card.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

RUN = """
import os, sys, tempfile
sys.path.insert(0, os.getcwd())
import torch
import torch.distributed as dist
import chip_smoke as c
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.launch import mesh as pmesh
resolve_device("cuda")
build.build_all()
c.train_full("12b", "phi3-mini-3.8b", 4, 1024)
c.train_full("12c", "granite-moe-1b-a400m", 8, 512)
with tempfile.TemporaryDirectory() as d:
    dist.init_process_group(
        "nccl", store=dist.FileStore(os.path.join(d, "store"), 1), rank=0,
        world_size=1, device_id=torch.device("cuda", 0))
    try:
        c.train_full("13c", "phi3-mini-3.8b", 4, 1024,
                     mesh=pmesh.make_pod_mesh(1))
    finally:
        dist.destroy_process_group()
"""

STEP = re.compile(r"\] (1[23][bc]) \S+ B=\d+, S=\d+.* step ([\d.]+) ms "
                  r"\(median")
PROF = re.compile(r"\] (1[23][bc]) \S+ step \d+ under torch.profiler: "
                  r"([\d.]+) ms of host time, ([\d.]+) ms of kernel time "
                  r"\(device idle ([\d.]+)\); (\d+) top-level aten ops, "
                  r"(\d+) device kernels")


def run(root: str) -> dict:
    root = os.path.abspath(root)
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=root, env=env,
                          capture_output=True, text=True, timeout=900)
    res = {"root": root, "rc": proc.returncode}
    for line in proc.stdout.splitlines():
        if re.search(r"\] 1[23][bc] ", line):
            print(f"{root}: {line}", flush=True)
        m = STEP.search(line)
        if m:
            res.setdefault(m[1], {})["step_ms"] = float(m[2])
        m = PROF.search(line)
        if m:
            res.setdefault(m[1], {}).update(
                host_ms=float(m[2]), kernel_ms=float(m[3]),
                idle=float(m[4]), aten_ops=int(m[5]), kernels=int(m[6]))
    if proc.returncode:
        print(f"{root}: rc {proc.returncode}\n{proc.stderr[-3000:]}",
              flush=True)
    return res


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__)
        return 2
    results = [run(root) for root in argv]
    for res in results:
        print(json.dumps(res), flush=True)
    return max(r["rc"] != 0 for r in results)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
