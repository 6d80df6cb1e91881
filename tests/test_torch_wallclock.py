"""The port's machine-time spans and counters (``telemetry/wallclock``).

With nobody listening a span is one shared no-op object that allocates
nothing.  A seeded HeteroFL and AnycostFL sync round, pooled and not,
gives the same parameters, ``History`` and event trace with a recorder
on as with none.  The recorder's tree: one ``prepare`` a device and one
``materialize`` a trained device in each round, as many ``train.step``
as the groups' steps (pooled) or the devices' (unpooled), each self time
the total less its children's, ``h2d_bytes`` the minibatches' bytes,
``train.lane_steps`` the lanes' steps of the pool's groups.
Under ``profile_trace`` (a CPU ``torch.profiler``) every span name is a
``user_annotation`` nested in its parent's.  Aggregates stay one per
name however many spans close.
"""
import contextlib
import dataclasses
import itertools
import json
import tracemalloc

import pytest

torch = pytest.importorskip("torch")

from repro_torch.orchestrator import runner  # noqa: E402
from repro_torch.orchestrator.policies import (OrchestratorConfig,  # noqa: E402
                                               make_policy)
from repro_torch.sysmodel.population import FleetConfig  # noqa: E402
from repro_torch.telemetry import profile_trace, wallclock  # noqa: E402
from repro_torch.train.fl_loop import FLRunConfig  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TINY = dict(rounds=2, n_train=128, n_test=64, eval_every=1, lr=0.1,
            seed=0, use_planner=False)
N_DEVICES = 4
CASES = [(m, pool) for m in ("heterofl", "anycostfl")
         for pool in (True, False)]


def _run(method, pool, rounds=TINY["rounds"]):
    """(sim, History) of a tiny sync run on the CPU, driven as
    ``run_orchestrated`` drives it."""
    cfg = FLRunConfig(method=method, **{**TINY, "rounds": rounds})
    orch = OrchestratorConfig(use_pool=pool)
    sim = runner.Simulation(cfg, FleetConfig(n_devices=N_DEVICES),
                            device="cpu")
    policy = make_policy(orch, fleet_T_max=sim.fleet_cfg.T_max)
    return sim, runner._run_round_based(sim, policy, orch, False)


@pytest.fixture(scope="module")
def runs():
    """Per case: the run with no recorder, the run with one, and that
    recorder."""
    out = {}
    for method, pool in CASES:
        _, off = _run(method, pool)
        with wallclock.recording() as rec:
            sim, on = _run(method, pool)
        out[method, pool] = (off, on, sim, rec)
    return out


def _peak_bytes(body, n=10_000):
    """The most memory traced while ``body()`` runs ``n`` times."""
    body()                         # the interpreter's first-call caches
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base, _ = tracemalloc.get_traced_memory()
        for _ in itertools.repeat(None, n):
            body()
        return tracemalloc.get_traced_memory()[1] - base
    finally:
        tracemalloc.stop()


def test_the_off_path_is_one_object_and_allocates_nothing():
    """The span and the counter allocate nothing: a ``with`` on the
    no-op span traces what a ``with`` on a constant context does (the
    interpreter's own bound ``__exit__``, freed at once)."""
    first = wallclock.span("round")
    seen = set()
    null = contextlib.nullcontext()

    def spans():
        with wallclock.span("round") as s:
            if s is not first:
                seen.add(s)
        wallclock.count("h2d_bytes", 1)

    def constant():
        with null:
            pass

    assert _peak_bytes(lambda: wallclock.span("round")) == \
        _peak_bytes(lambda: None)
    assert _peak_bytes(spans) == _peak_bytes(constant)
    assert not seen


@pytest.mark.parametrize("method,pool", CASES)
def test_recording_is_bitwise_invisible(runs, method, pool):
    off, on, _, _ = runs[method, pool]
    assert [dataclasses.asdict(r) for r in on.rounds] == \
        [dataclasses.asdict(r) for r in off.rounds]
    assert on.trace == off.trace
    for a, b in zip(tree_leaves(on.final_params),
                    tree_leaves(off.final_params)):
        assert torch.equal(a, b)


def _children(records):
    kids = {}
    for r in records:
        kids.setdefault(r.parent, []).append(r)
    return kids


def _steps(sim, i):
    """Device i's local steps (``fl_loop._device_batches``' count)."""
    n, rc = len(sim.parts[i]), sim.run_cfg
    return max(int(round(rc.tau * n / min(rc.batch_size, n))), 1)


@pytest.mark.parametrize("method,pool", CASES)
def test_the_span_tree_of_a_round(runs, method, pool):
    _, hist, sim, rec = runs[method, pool]
    records = rec.records()
    assert rec.dropped == 0
    kids = _children(records)
    rounds = sorted((r for r in records if r.name == "round"),
                    key=lambda r: r.index)
    assert len(rounds) == TINY["rounds"]
    for r, log in zip(rounds, hist.rounds):
        names = [c.name for c in kids[r.index]]
        # the tiny fleet trains every device it prepares
        assert names.count("prepare") == N_DEVICES
        assert log.n_clients + log.n_dropped == N_DEVICES
        assert names.count("materialize") == N_DEVICES
        train = [c for c in kids[r.index] if c.name == "train"]
        assert len(train) == 1
        steps = [s for s in records if s.name == "train.step"
                 and train[0].start_ns <= s.start_ns
                 and s.end_ns <= train[0].end_ns]
        groups = [g for g in kids[train[0].index] if g.name == "train.group"]
        if pool:
            assert groups and len(steps) == sum(g.info["steps"]
                                                for g in groups)
            assert sum(g.info["lanes"] for g in groups) == N_DEVICES
            assert all(g.info["alpha"] in sim.run_cfg.alpha_buckets
                       for g in groups)
        else:
            assert not groups
            assert len(steps) == sum(_steps(sim, i)
                                     for i in range(N_DEVICES))
    # each self time is the duration less its children's (which never
    # overlap: they ran one after another on one thread)
    stats = rec.spans()
    for name, st in stats.items():
        mine = [r for r in records if r.name == name]
        assert st.calls == len(mine)
        assert st.total_ns == sum(r.duration_ns for r in mine)
        assert st.self_ns == sum(
            r.duration_ns - sum(c.duration_ns for c in kids.get(r.index, []))
            for r in mine)
        assert 0 <= st.self_ns <= st.total_ns
    sample = sim.train.x[0].nbytes + sim.train.y[0].nbytes
    bs = sim.run_cfg.batch_size
    want = {"h2d_bytes": TINY["rounds"] * sum(
        _steps(sim, i) * min(bs, len(sim.parts[i])) * sample
        for i in range(N_DEVICES))}
    # every lane's step of a group of more than one, written out (a CNN)
    lane_steps = sum(r.info["lanes"] * r.info["steps"] for r in records
                     if r.name == "train.group" and r.info["lanes"] > 1)
    if lane_steps:
        want["train.lane_steps"] = lane_steps
    assert rec.counters() == want
    assert {"setup.build", "setup.data", "setup.model", "setup.fleet",
            "setup.test_h2d", "round.sort", "round.gate", "round.log",
            "prepare.strategy", "prepare.draw", "prepare.h2d",
            "train.shrink", "materialize.expand", "materialize.compress",
            "materialize.costs", "aggregate", "aggregate.aio",
            "aggregate.apply", "eval"} <= set(stats)


def _parent_name(name, names):
    head = name.rpartition(".")[0]
    if head in names:
        return head
    return "setup.build" if name.startswith("setup.") else "round"


def test_the_spans_land_in_the_profilers_trace(tmp_path):
    with wallclock.recording() as rec:
        _run("anycostfl", True, rounds=1)
    names = set(rec.spans())
    with profile_trace(str(tmp_path)) as prof_dir:
        _run("anycostfl", True, rounds=1)
    with open(f"{prof_dir}/trace.json") as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") in names]
    assert {e["name"] for e in marks} == names
    for e in marks:
        if e["name"] in ("setup.build", "round"):
            continue
        parent = _parent_name(e["name"], names)
        assert any(p["name"] == parent and p["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                   for p in marks), e["name"]


def test_aggregates_stay_one_per_name():
    n = wallclock.CAPACITY + 1000
    with wallclock.recording() as rec:
        for _ in range(n):
            with wallclock.span("train.step"):
                pass
    assert list(rec.spans()) == ["train.step"]
    assert rec.spans()["train.step"].calls == n
    assert len(rec.records()) == wallclock.CAPACITY and rec.dropped == 1000


def test_loop_closes_its_span_on_break_and_recorders_nest():
    with wallclock.recording() as outer:
        for i in wallclock.loop("round", range(5)):
            with wallclock.recording() as inner:
                wallclock.count("h2d_bytes", 2)
            if i == 2:
                break
        assert outer.spans()["round"].calls == 3
        assert not outer._stack
    assert inner.counters() == {"h2d_bytes": 2}
    assert outer.counters() == {}
