"""The DeepSeek-V2-Lite cell (``dsv2lite-anycost-2pod-s4096``): its files,
the pod step against the latent-attention MoE reference at a small size
on the CPU, its planted faults and float8 control, the grouped GEMMs'
counters and roofline, and one run on the card at the published widths."""
import json
import re

import pytest
import torch

import run
from programs import pod_step

SEED = 2 ** 31 + 3232
CELL = "dsv2lite-anycost-2pod-s4096"
SMALL = json.loads((run.HERE / "workloads" / f"{CELL}.json").read_text())[
    "small"]


def _small():
    return {k: dict(v) for k, v in SMALL.items()}


def test_the_cell_finds_its_files():
    manifest, entry, config, traffic, cell = run.load_cell(CELL)
    assert entry["chips"] == 1 and config["program"] == "pod_step"
    fam = config["model"]["family"]
    for path in (f"reference/lm_{fam}.py", f"roofline/lm_{fam}.py",
                 "roofline/grouped_mm.py"):
        assert (run.HERE / path).is_file(), path
    names = run.metric_names(manifest, entry, False) \
        + run.metric_names(manifest, entry, True)
    assert {"round_s", "peak_gib", "setup_s", "moe_ms", "moe_roofline",
            "grad_ms", "sync_ms", "optim_ms", "aio_roofline", "device_idle",
            "round_mfu"} == set(names)
    for name in names:
        assert (run.HERE / "metrics" / f"{name}.py").is_file()
    # the catalog's published depth stands at the top level; the run's is
    # the model's
    assert config["num_hidden_layers"] == 27 == config["depth"]["published"]
    assert config["model"]["n_layers"] == config["depth"]["run"] == 5


def test_a_small_run_is_correct():
    result, lines = run.run_cell(CELL, SEED, 0.1, True, device="cpu",
                                 overrides=_small())
    assert result["correct"], lines
    # the CPU runs no kernel: no device metric is read
    assert not {"grad_ms", "moe_ms", "moe_roofline"} & set(result["metrics"])


@pytest.mark.parametrize("fault,number", [
    ("half_batch", "grad_gap"), ("peers_dropped", "grad_gap"),
    ("sync_skipped", "update_gap"), ("lr_doubled", "update_gap"),
    ("zeroed_layer", "grad_gap"), ("frozen", "update_gap")])
def test_a_broken_step_is_not_correct(fault, number):
    result, _ = run.run_cell(CELL, SEED, 0.1, False, device="cpu",
                             overrides=_small(),
                             fault=pod_step.FAULTS[fault])
    assert not result["correct"]
    value, limit = result["check"][number]
    assert value > limit


def test_the_float8_control_is_not_correct():
    from bench import check
    _, _, config, traffic, cell = run.load_cell(CELL, _small())
    rec = pod_step.control(config, traffic, cell, SEED, "cpu")
    nums = pod_step.follow(config, traffic, cell, SEED, "cpu", rec)
    correct, shown = check.judge(nums, cell["check"]["limits"])
    assert not correct, shown


def test_the_counters_sum_the_launches_shapes(monkeypatch):
    """The grouped products' counters over a checked step equal the sums
    over its launches' shapes: in each MoE layer three products (gate
    and up ``d -> f``, down ``f -> d``) over the layer's ``M`` rows (its
    assignments, the routing's counts summed), each run in the forward,
    again in remat's recompute, and twice in the backward (the input and
    the weight gradient).  The card's route is driven on the CPU with
    ``torch._grouped_mm`` standing in for the CUTLASS launch."""
    from repro_torch.kernels import grouped_mm, ops
    from repro_torch.telemetry import wallclock

    def cpu_grouped(a, b, offs):
        if b.dim() == 3:
            return grouped_mm.grouped_mm_ref(a, b, offs)
        return grouped_mm.grouped_mm_t_ref(a.t(), b, offs)

    monkeypatch.setattr(grouped_mm, "_check", lambda *a: None)
    monkeypatch.setattr(torch, "_grouped_mm", cpu_grouped, raising=False)
    # the card's route for the grouped product alone, the one operation
    # given int32 offsets
    on_cuda = ops._on_cuda
    monkeypatch.setattr(ops, "_on_cuda", lambda *t: any(
        x.dtype == torch.int32 for x in t) or on_cuda(*t))
    _, _, config, traffic, cell = run.load_cell(CELL, _small())
    prog = pod_step.build(config, traffic, cell, SEED, "cpu")
    try:
        ops.reset_launch_counts()
        with wallclock.recording() as rec:
            prog.round()
        got = ops.launch_counts()
    finally:
        prog.close()
    from repro_torch.configs import get_config
    m = config["model"]
    E, f, d = (get_config(m["name"]).dsmoe.n_routed_experts,
               get_config(m["name"]).dsmoe.expert_d_ff, m["d_model"])
    n_moe = m["n_layers"] - config["first_k_dense_replace"]
    M = rec.counters()["moe.rows"] / n_moe
    assert rec.counters()["moe.dropped"] == 0
    assert M == traffic["batch"] * traffic["seq_len"] \
        * config["num_experts_per_tok"]
    shapes = [(d, f), (d, f), (f, d)]
    assert got["grouped_mm"] == 4 * 3 * n_moe
    assert got["grouped_mm_macs"] == 4 * n_moe * sum(M * k * n
                                                     for k, n in shapes)
    assert got["grouped_mm_elems"] == 4 * n_moe * sum(
        M * k + E * k * n + M * n for k, n in shapes)


@pytest.mark.parametrize("share", [1.0, 0.4])
def test_the_roofline_share_stays_under_100(share):
    """A constructed trace whose grouped kernels take exactly the bound
    time (bf16 peak or HBM, the longer) reads 100 %; slower, less."""
    from metrics import moe_ms, moe_roofline
    from roofline import PEAKS, grouped_mm
    counters = {"grouped_mm": 12, "grouped_mm_macs": 3 * 10 ** 12,
                "grouped_mm_elems": 4 * 10 ** 9}
    bound = max(2 * 4e9 / PEAKS["hbm_bytes_per_s"],
                2 * 3e12 / PEAKS["bf16_flops_per_s"])
    device = bound / share
    names = ["void at::cuda::detail::prepare_grouped_gemm_data<cutlass::"
             "bfloat16_t>(...)", "_ZN7cutlass13device_kernelIN2at4cuda6"
             "detail25enable_3x_kernel_for_sm9xINS_4gemm6kernel13"
             "GemmUniversalINS5_17GroupProblemShapeIN4cute5tupleIJiiiEEEE"]
    assert all(any(re.search(p, n) for p in grouped_mm.PATTERNS)
               for n in names)
    ctx = {"launches": counters, "profiled_rounds": 1,
           "trace": {"kernels": {names[0]: 0.01 * device,
                                 names[1]: 0.99 * device,
                                 "sgemm_128x256": 5.0}}}
    assert moe_roofline.read(ctx) == pytest.approx(100.0 * share)
    assert moe_roofline.read(ctx) <= 100.0 + 1e-9
    assert moe_ms.read(ctx) == pytest.approx(1e3 * device)
    # a program without the kernels reads nothing
    assert moe_roofline.read({"launches": {}, "trace": {}}) is None
    assert moe_ms.read({"trace": {"kernels": {"sgemm": 1.0}},
                        "profiled_rounds": 1}) is None


@pytest.mark.gpu
def test_two_layers_at_published_widths_on_the_card(cuda):
    """DeepSeek-V2-Lite's widths at two layers (the dense one and a MoE
    one) on the card: ``correct``, every metric of the cell read, the
    grouped kernels' names matched by ``PATTERNS``."""
    over = {"model": {"n_layers": 2}}
    manifest, entry, *_ = run.load_cell(CELL)
    for trace in (False, True):
        result, lines = run.run_cell(CELL, SEED, 2.0, trace, device=cuda,
                                     overrides=over)
        assert result["correct"], lines
        assert set(result["metrics"]) == set(
            run.metric_names(manifest, entry, trace))
        print(json.dumps(result["metrics"]))
    # moe_ms reads only the kernels PATTERNS matches in the trace
    assert result["metrics"]["moe_ms"]["value"] > 0
    assert 0 < result["metrics"]["moe_roofline"]["value"] <= 100
