"""The port's roofline (``repro_torch/launch/roofline.py``) against the
reference's (``repro/launch/roofline.py``) on the CPU.

The analytic cost model and the useful-work model equal the reference's
with ``==`` over every assigned arch x input shape (the dry-run's plan,
the long-context sliding-window variants included) x remat policy x
``causal_skip`` x mesh size; the wire factors equal per collective; the
roofline terms follow the H100 constants; and the collective recorder
gives each functional and c10d collective's ring wire bytes on a fake
group of 8 ranks (in a subprocess: a process group is process-wide).
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import roofline as jrl  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: (n_chips, data_shards) of the single- and two-pod production meshes
MESH_SIZES = ((256, 16), (512, 32))


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_analytic_cost_and_model_flops_equal_the_reference(arch):
    n = 0
    for name in INPUT_SHAPES:
        want_entry = jdryrun.plan_entry(arch, name)
        got_entry = dryrun.plan_entry(arch, name)
        assert (want_entry is None) == (got_entry is None)
        if want_entry is None:
            continue
        (jcfg, jshape, jnote), (cfg, shape, note) = want_entry, got_entry
        assert note == jnote
        assert rl.model_flops(cfg, shape) == jrl.model_flops(jcfg, jshape)
        for remat in ("full", "dots", "none"):
            for causal_skip in (False, True):
                for n_chips, data_shards in MESH_SIZES:
                    kw = dict(remat=remat, causal_skip=causal_skip,
                              n_chips=n_chips, data_shards=data_shards)
                    assert rl.analytic_cost(cfg, shape, **kw) \
                        == jrl.analytic_cost(jcfg, jshape, **kw)
                    n += 1
    assert n >= 3 * 2 * 2 * 3


@pytest.mark.parametrize("op,out_bytes,group", [
    ("all-reduce", 100, 2), ("all-gather", 160, 16),
    ("reduce-scatter", 10, 16), ("all-to-all", 64, 8),
    ("collective-permute", 7, 4), ("all-reduce", 100, 1),
    ("broadcast", 100, 8)])
def test_wire_factors_equal_the_reference(op, out_bytes, group):
    assert rl._wire_bytes(op, out_bytes, group) \
        == jrl._wire_bytes(op, out_bytes, group)


def test_derive_on_the_h100_constants():
    coll = rl.CollectiveStats({}, 4.5e9, 9e9)
    analytic = {"flops_per_device": 989e12 * 2.0,
                "bytes_per_device": 3.35e12 * 0.5}
    r = rl.derive({"flops": 123.0}, coll, n_chips=4,
                  model_flops_total=4 * 989e12, analytic=analytic)
    assert (rl.H100_PEAK_FLOPS, rl.H100_HBM_BW, rl.H100_NVLINK_BW) \
        == (989e12, 3.35e12, 450e9)
    assert r.t_compute == pytest.approx(2.0)
    assert r.t_memory == pytest.approx(0.5)
    assert r.t_collective == pytest.approx(0.01)
    assert r.bottleneck == "compute"
    assert r.useful_ratio == pytest.approx(0.5)
    assert r.hlo_flops == 123.0 and r.hlo_bytes == 0.0
    # without the analytic model the trace's flops are the compute term
    r = rl.derive({"flops": 989e12}, coll, n_chips=1, model_flops_total=0.0)
    assert r.t_compute == pytest.approx(1.0) and r.t_memory == 0.0
    assert set(r.to_dict()) == set(jrl.Roofline.__dataclass_fields__)


RECORD = r"""
import json
import torch, torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from repro_torch.launch import dryrun, roofline as rl
dryrun.fake_group(8)
g = dist.group.WORLD
x = torch.ones(16, 4)
with rl.CollectiveRecorder() as rec:
    funcol.all_gather_single(x, 0, g)
    funcol.all_reduce(x, "sum", g)
    funcol.reduce_scatter_single(x, "sum", 0, g)
    dist.all_reduce(x)
    dist.all_gather([torch.empty_like(x) for _ in range(8)], x)
    y = x + 1                      # not a collective
print(json.dumps({"calls": rec.calls, "stats": rec.stats().to_dict()}))
"""


def test_recorder_counts_wire_bytes_on_a_fake_group_of_8():
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", RECORD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    n = 16 * 4 * 4                       # bytes of x
    calls = [(c["op"], c["bytes"], c["group"], c["wire_bytes"])
             for c in got["calls"]]
    assert calls == [
        ("all-gather", 8 * n, 8, 7 / 8 * 8 * n),
        ("all-reduce", n, 8, 2 * 7 / 8 * n),
        ("reduce-scatter", n // 8, 8, 7 * n // 8),
        ("all-reduce", n, 8, 2 * 7 / 8 * n),
        ("all-gather", 8 * n, 8, 7 / 8 * 8 * n)]
    for op, out_bytes, group, wire in calls:
        assert wire == jrl._wire_bytes(op, out_bytes, group)
    stats = got["stats"]
    assert stats["by_op"]["all-reduce"]["count"] == 2
    assert stats["wire_bytes"] == pytest.approx(sum(c[3] for c in calls))
