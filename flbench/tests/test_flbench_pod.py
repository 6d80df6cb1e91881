"""The pod step (``programs/pod_step.py``) against its plain reference at a
small size on the CPU, its planted faults and control, the reference
found by the family's name, and one run on the card.

A sound run must come out ``correct``; the run with the timed path broken
underneath must not, once for each fault the cell can have: the loss of
half of each batch, the other pod's rows left out of Eq. 5, the whole
sync left out, the rate doubled, a layer's gradient zeroed, a step that
hands its state back unchanged."""
import json
import shutil
import subprocess
import sys

import pytest

import run
from programs import pod_step

SEED = 2 ** 31 + 23
CELL = "phi3-anycost-2pod-s4096"
SMALL = json.loads((run.HERE / "workloads" / f"{CELL}.json").read_text())[
    "small"]


def _small():
    return {k: dict(v) for k, v in SMALL.items()}


def test_a_traced_pod_run_is_correct_and_reads_its_shape():
    result, lines = run.run_cell(CELL, SEED, 0.1, True, device="cpu",
                                 overrides=_small())
    assert result["correct"], lines
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU runs no kernel: no device metric is read, none reads 0
    assert not {"grad_ms", "sync_ms", "optim_ms"} & set(result["metrics"])


@pytest.mark.parametrize("fault,number", [
    ("half_batch", "grad_gap"), ("peers_dropped", "grad_gap"),
    ("sync_skipped", "update_gap"),
    ("lr_doubled", "update_gap"), ("zeroed_layer", "grad_gap"),
    ("frozen", "update_gap")])
def test_a_broken_pod_step_is_not_correct(fault, number):
    result, _ = run.run_cell(CELL, SEED, 0.1, False, device="cpu",
                             overrides=_small(),
                             fault=pod_step.FAULTS[fault])
    assert not result["correct"]
    value, limit = result["check"][number]
    assert value > limit


def test_the_faults_leave_the_port_as_it_was():
    from repro_torch.core import distributed
    from repro_torch.kernels import ops
    from repro_torch.launch import steps

    def now():
        return (steps.value_and_grad, steps.anycost_gradient_sync,
                distributed._all_gather, ops.aio_aggregate_op)

    before = now()
    for fault in ("half_batch", "sync_skipped", "zeroed_layer"):
        run.run_cell(CELL, SEED, 0.1, False, device="cpu",
                     overrides=_small(), fault=pod_step.FAULTS[fault])
    run.run_cell(CELL, SEED, 0.1, True, device="cpu", overrides=_small())
    assert now() == before


def test_the_other_pods_rows_are_this_pods_rolled():
    import torch
    from bench import lm_inputs
    t = torch.arange(10, dtype=torch.int8).view(2, 5)
    rows = lm_inputs.pod_rows(SEED, t, 2)
    assert rows.shape == (3, 2, 5) and torch.equal(rows[0], t)
    for pod in (1, 2):
        s = lm_inputs.peer_shift(SEED, pod, 10)
        assert torch.equal(rows[pod].reshape(-1), t.reshape(-1).roll(s))
    assert lm_inputs.pod_rows(SEED, t, 0).shape == (1, 2, 5)


def test_a_sliding_window_shorter_than_the_rows_is_correct():
    """The window masks keys on both sides alike (the cell's 2047 of
    4096 tokens, here 8 of 32)."""
    from bench import check
    _, _, config, traffic, cell = run.load_cell(CELL, _small())
    config["sliding_window"] = 8
    prog = pod_step.build(config, traffic, cell, SEED, "cpu")
    try:
        prog.checked()
        rec = prog.release()
    finally:
        prog.close()
    nums = pod_step.follow(config, traffic, cell, SEED, "cpu", rec)
    correct, shown = check.judge(nums, cell["check"]["limits"])
    assert correct, shown
    config["sliding_window"] = None
    other = pod_step.follow(config, traffic, cell, SEED, "cpu", rec)
    assert not check.judge(other, cell["check"]["limits"])[0]


def test_readings_give_the_lower_and_upper_sides():
    import readings
    got = list(readings.readings(CELL, [SEED], [SEED], ["lr_doubled"],
                                 device="cpu", overrides=_small()))
    assert [r["kind"] for r in got] == ["program", "control",
                                        "fault_lr_doubled"]
    _, _, _, _, cell = run.load_cell(CELL)
    limits = cell["check"]["limits"]
    assert all(got[0]["numbers"][k] <= v for k, v in limits.items())
    assert got[2]["numbers"]["update_gap"] > limits["update_gap"]


def test_the_float8_control_is_not_correct():
    from bench import check
    _, _, config, traffic, cell = run.load_cell(CELL, _small())
    rec = pod_step.control(config, traffic, cell, SEED, "cpu")
    nums = pod_step.follow(config, traffic, cell, SEED, "cpu", rec)
    correct, shown = check.judge(nums, cell["check"]["limits"])
    assert not correct, shown


def test_the_program_holds_the_references_layout():
    """A port architecture of another family than the reference's (an
    MoE under the dense reference) is refused before a step runs."""
    with pytest.raises(ValueError, match="layout"):
        run.run_cell(CELL, SEED, 0.1, False, device="cpu",
                     overrides={**_small(), "model": {
                         **SMALL["model"], "name": "granite-moe-1b-a400m"}})


TOY = '''"""A family found by its name: the dense reference, marked."""
import sys

from reference.lm_dense import *  # noqa: F401,F403
from reference import lm_dense


def loss_and_grads(*args, **kwargs):
    print("lm_toy", file=sys.stderr)
    return lm_dense.loss_and_grads(*args, **kwargs)
'''

DRIVE = '''import json, sys
sys.path.insert(0, "flbench")
sys.path.insert(0, {src!r})
import run
small = json.loads({small!r})
small["model"]["family"] = "toy"
result, lines = run.run_cell({cell!r}, {seed}, 0.1, False, device="cpu",
                             overrides=small)
print(json.dumps(result["correct"]))
'''


def test_a_new_family_is_found_by_its_name(tmp_path):
    """A reference module for another family, written into a copy of the
    harness beside the others, is the one a configuration of that family
    runs against: no file the harness has is edited."""
    shutil.copytree(run.HERE, tmp_path / "flbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (tmp_path / "flbench" / "reference" / "lm_toy.py").write_text(TOY)
    for f in run.HERE.rglob("*.py"):
        rel = f.relative_to(run.HERE)
        if rel.parts[0] != "tests":
            assert (tmp_path / "flbench" / rel).read_text() == f.read_text()
    code = DRIVE.format(src=str(run.ROOT / "src"), small=json.dumps(SMALL),
                        cell=CELL, seed=SEED)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "true"
    # the reference's loss and gradients, once a checked step
    steps = run.load_cell(CELL)[4]["check"]["steps"]
    assert out.stderr.count("lm_toy") == steps


@pytest.mark.gpu
def test_a_reduced_depth_pod_run_on_the_card(cuda):
    """phi-3-mini at its published widths and four of its layers, on the
    card: ``correct``, and every metric of the cell read, #6's roofline
    among them."""
    over = {"model": {"n_layers": 4}}
    manifest, entry, *_ = run.load_cell(CELL)
    for trace in (False, True):
        result, lines = run.run_cell(CELL, SEED, 2.0, trace, device=cuda,
                                     overrides=over)
        assert result["correct"], lines
        assert set(result["metrics"]) == set(
            run.metric_names(manifest, entry, trace))
        print(json.dumps(result["metrics"]))


def test_a_traced_pod_run_profiles_the_cells_rounds(monkeypatch):
    """The cell's settings name how many rounds run under the profiler
    (a step of the cell at full size traces for minutes)."""
    from bench import trace
    seen = []
    profile = trace.profile_rounds

    def counted(step, n_rounds, **kw):
        seen.append(n_rounds)
        return profile(step, n_rounds, **kw)

    monkeypatch.setattr(trace, "profile_rounds", counted)
    run.run_cell(CELL, SEED, 0.1, True, device="cpu", overrides=_small())
    assert seen == [run.load_cell(CELL)[4]["profiled_rounds"]] == [1]
