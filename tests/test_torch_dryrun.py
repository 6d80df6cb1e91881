"""The port's dry-run (``repro_torch/launch/dryrun.py``) on a fake 8-rank
(pod=2, data=2, model=2) mesh, the counterpart of
``tests/test_dryrun_mini.py``: the same six (arch, kind) pairs, reduced,
traced once on ``meta`` tensors.  The traces run in two subprocesses
beside each other (a process group is process-wide; each joins a fake
group of 8 and traces its pairs).

Each pair gives flops > 0 and collectives > 0; granite-moe's ``"anycost"``
step puts at most 1.5 times the ``"auto"`` step's bytes on the wire (the
reference's bound); and rank 0's argument bytes equal the local shard
bytes of the reference's in-shardings (``jax.sharding.AbstractMesh``, no
devices).  The CLI skips and fails as the reference's does.
"""
import json
import math
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import sharding as jshd  # noqa: E402
from repro.configs import get_config  # noqa: E402
from repro.configs.base import InputShape  # noqa: E402
from repro.launch.steps import make_step_and_args, rules_for  # noqa: E402
from repro.models.registry import build_model  # noqa: E402
from repro.train.optimizer import adamw  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
PAIRS = [("qwen2-7b", "train", "auto"), ("falcon-mamba-7b", "train", "auto"),
         ("granite-moe-1b-a400m", "train", "auto"),
         ("recurrentgemma-9b", "decode", "auto"),
         ("pixtral-12b", "prefill", "auto"),
         ("seamless-m4t-large-v2", "decode", "auto"),
         ("granite-moe-1b-a400m", "train", "anycost")]
SHAPES = {"train": ("mini_train", 64, 8, "train"),
          "decode": ("mini_decode", 128, 8, "decode"),
          "prefill": ("mini_prefill", 64, 8, "prefill")}
MESH = ((2, 2, 2), ("pod", "data", "model"))

SCRIPT = r"""
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh

pairs, shapes, (shape, axes) = json.loads(sys.argv[1])
dryrun.fake_group(8)
mesh = make_mesh(tuple(shape), tuple(axes), "cpu")
out = {}
for arch, kind, gs in pairs:
    tr = dryrun.trace_step(get_config(arch).reduced(),
                           InputShape(*shapes[kind]), mesh, remat="none",
                           grad_sync=gs)
    coll = tr["collectives"]
    out["|".join((arch, kind, gs))] = {
        "flops": tr["flops"], "wire": coll.wire_bytes,
        "n_coll": sum(d["count"] for d in coll.by_op.values()),
        "args": tr["memory"]["argument_size_in_bytes"]}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def traces():
    env = dict(os.environ, PYTHONPATH=SRC)
    halves = [PAIRS[0::2], PAIRS[1::2]]
    procs = [subprocess.Popen(
        [sys.executable, "-c", SCRIPT, json.dumps([h, SHAPES, MESH])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for h in halves]
    out = {}
    for p in procs:
        stdout, stderr = p.communicate(timeout=600)
        assert p.returncode == 0, stderr[-3000:]
        out.update(json.loads(stdout.strip().splitlines()[-1]))
    return out


def _reference_arg_bytes(arch, kind, gs):
    """Rank 0's bytes of the reference's step arguments: each leaf's shard
    shape under its in-sharding."""
    cfg = get_config(arch).reduced()
    shape = InputShape(*SHAPES[kind])
    mesh = AbstractMesh(*MESH)
    with jshd.use_sharding(mesh, rules_for(shape, gs)):
        _, args, in_sh, _ = make_step_and_args(
            build_model(cfg), adamw(1e-3), shape, remat="none",
            grad_sync=gs, mesh=mesh)
    leaves = jax.tree.leaves(args)
    shards = jax.tree.leaves(in_sh, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(shards)
    return sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
               for a, s in zip(leaves, shards))


@pytest.mark.parametrize("arch,kind,gs", PAIRS)
def test_mini_dryrun(traces, arch, kind, gs):
    res = traces["|".join((arch, kind, gs))]
    assert res["flops"] > 0
    assert res["n_coll"] > 0          # a sharded step moves data
    assert res["args"] == _reference_arg_bytes(arch, kind, gs)


def test_anycost_grad_sync_traces_and_cuts_wire_bytes(traces):
    base = traces["granite-moe-1b-a400m|train|auto"]
    comp = traces["granite-moe-1b-a400m|train|anycost"]
    assert comp["n_coll"] > 0
    assert comp["wire"] <= base["wire"] * 1.5


def test_cli_skips_and_fails_as_the_reference_does(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "seamless-m4t-large-v2", "--shape", "long_500k", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    assert run.stdout.startswith("[SKIP] seamless-m4t-large-v2 x long_500k")
    saved = json.loads((tmp_path / "seamless-m4t-large-v2__long_500k__"
                        "single__baseline.json").read_text())
    assert saved["skipped"] is True
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "no-such-arch", "--shape", "train_4k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "[FAIL] no-such-arch x train_4k (single)" in run.stdout
    assert (tmp_path / "no-such-arch__train_4k__single__baseline.FAIL.txt"
            ).exists()
