"""The plain reference against the port at a small size on the CPU, the
comparison's faults, and the control on the card.

A sound run must come out ``correct``; the run with the timed path broken
underneath must not, once for each fault a cell can have: local training
that returns its state unchanged (in the pool, or in the round loop that
hands its result on), only the first local step taken, half of each
minibatch left out (the mean over the rest), an uploaded update altered
where it is produced, and its wire size misstated.  One chip has no
exchange between chips to leave out."""
import dataclasses
import json

import pytest
import torch

import run
from bench import check, inputs
from reference import fl as ref_fl

SEED = 2 ** 31 + 17
CELLS = [w["name"] for w in json.loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, small):
    result, lines = run.run_cell(cell, SEED, 0.1, False, device="cpu",
                                 overrides=small)
    assert result["correct"], lines
    assert list(result)[-1] == "check"
    assert result["attempted"] >= 1 and result["failed"] == 0
    manifest, entry, *_ = run.load_cell(cell)
    assert set(result["metrics"]) == set(
        run.metric_names(manifest, entry, False))
    assert {"round_s", "peak_gib", "setup_s"} <= set(result["metrics"])


def test_a_traced_run_reads_its_spans(small):
    result, _ = run.run_cell(CELLS[0], SEED, 0.1, True, device="cpu",
                             overrides=small)
    assert result["correct"]
    for name in ("prepare_ms", "train_ms", "materialize_ms",
                 "aggregate_ms", "eval_ms"):
        assert result["metrics"][name]["value"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


#: FedAvg's FMNIST CNN at 32 samples a device, where the paper's budgets
#: leave AnycostFL's devices feasible (at its full 1000 none is)
FMNIST = {"model": {"name": "fmnist-cnn", "n_layers": 2, "d_model": 32,
                    "d_ff": 512, "vocab_size": 10, "n_params": 1663370},
          "data": {"image_shape": [28, 28, 1]}}


@pytest.mark.parametrize("cells", [1, 2])
def test_the_anycost_round_matches_the_reference(cells, small):
    """The reference's AnycostFL path (strategies, the beta planner, FGC,
    Theorem 1's weights; with two cells the edge partials and the cloud
    merge) against the port, which no cell of the benchmark reaches
    yet."""
    over = {**small, "model": FMNIST["model"],
            "data": {**small["data"], **FMNIST["data"]},
            "traffic": {**small["traffic"], "method": "anycostfl",
                        "cells": cells}}
    result, lines = run.run_cell(CELLS[0], SEED, 0.1, False, device="cpu",
                                 overrides=over)
    assert result["correct"], lines
    assert any(k.startswith("step_gap.a") for k in result["readings"])


def _frozen(prog):
    client = prog.sim.client

    def steps(params, batches):
        return {k: {n: t.clone() for n, t in v.items()}
                for k, v in params.items()}

    def batched(params, batches, *, shared):
        lanes = batches["images"].shape[0]
        return {k: {n: (t.expand(lanes, *t.shape) if shared else t).clone()
                    for n, t in v.items()} for k, v in params.items()}

    client._local_steps = steps
    client._local_steps_batched = batched


def _frozen_in_the_loop(prog):
    pool = prog.sim.pool
    train_shared = pool.train_shared

    def untrained(sorted_global, jobs):
        train_shared(sorted_global, jobs)
        return [j.sub_params for j in jobs]

    pool.train_shared = untrained


def _first_step_only(prog):
    client = prog.sim.client
    batched = client._local_steps_batched

    def first(params, batches, *, shared):
        return batched(params, {k: v[:, :1] for k, v in batches.items()},
                       shared=shared)

    client._local_steps_batched = first


def _half_batch(prog):
    from repro_torch.core import anycost
    loss_fn = anycost.loss_fn

    def half(model, params, batch, **kw):
        n = batch["labels"].shape[0] // 2
        return loss_fn(model, params, {k: v[:n] for k, v in batch.items()},
                       **kw)

    anycost.loss_fn = half
    prog.restore = lambda: setattr(anycost, "loss_fn", loss_fn)


def _altered(prog):
    from repro_torch.utils.pytree import tree_map
    sim = prog.sim
    materialize = sim.materialize
    seen = set()

    def altered(p, *a, **kw):
        p = materialize(p, *a, **kw)
        if not seen & {id(sim.params)}:
            seen.add(id(sim.params))
            p.update = dataclasses.replace(
                p.update, values=tree_map(lambda v: v * 2.0,
                                          p.update.values))
        return p

    sim.materialize = altered


def _bits(prog):
    sim = prog.sim
    materialize = sim.materialize

    def misstated(p, *a, **kw):
        p = materialize(p, *a, **kw)
        p.update = dataclasses.replace(p.update, bits=p.update.bits * 0.5)
        return p

    sim.materialize = misstated


@pytest.mark.parametrize("fault,number", [
    (_frozen, "step_gap"), (_frozen_in_the_loop, "step_gap"),
    (_first_step_only, "start_mismatch"), (_half_batch, "step_gap"),
    (_altered, "agg_gap"), (_bits, "bits_gap")])
def test_a_broken_timed_path_is_not_correct(fault, number, small):
    holder = {}

    def plant(prog):
        fault(prog)
        holder["prog"] = prog

    try:
        result, _ = run.run_cell(CELLS[0], SEED, 0.1, False, device="cpu",
                                 overrides=small, fault=plant)
    finally:
        getattr(holder.get("prog"), "restore", lambda: None)()
    assert not result["correct"]
    value, limit = result["check"][number]
    assert value > limit


@pytest.mark.gpu
def test_the_control_is_not_correct(cuda, small):
    """The reference in TF32, put in the program's place, fails the
    comparison with the float32 reference (run on the card: the CPU has
    no TF32)."""
    manifest, entry, config, traffic, cell = run.load_cell(CELLS[0], small)
    n = cell["check"]["rounds"]
    sample = inputs.sample_devices(SEED, config["fleet"]["n_devices"],
                                   cell["check"]["sample"])
    cap = check.Capture()
    ref_fl.simulate(config, traffic, SEED,
                    inputs.SeededUniforms(SEED, cuda), cuda, n, cap,
                    mode="tf32", sample=sample,
                    per_width=cell["check"]["per_width"])
    nums = ref_fl.follow(config, traffic, SEED,
                         inputs.SeededUniforms(SEED, cuda), cuda, cap, n)
    correct, shown = check.judge(nums, cell["check"]["limits"])
    assert not correct, shown
    assert torch.backends.cuda.matmul.allow_tf32 is False
