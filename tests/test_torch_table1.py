"""The paper's Table I methods and Fig. 5a ablations end to end in the
port, against live reference runs.

Each case runs the reference's TINY config (``tests/test_orchestrator.py``:
2 rounds, n_train 128, 3 devices, fmnist-cnn at full width) in the JAX
package and in the port, the port starting from the reference's initial
parameters, replaying the reference's JAX key chain as its uniform
source (as ``tests/test_torch_fl.py`` does) and starting each round from
the reference's round-start (sorted) parameters (as
``tests/test_torch_topology.py`` does: a level index flipped in one
round would otherwise move every later round's update).  The cases: the
six comparison methods (with the beta planner switched on, which the
reference fits for AnycostFL only, so a port that fitted it would draw
from the key chain out of step), the three ablations, one non-iid
AnycostFL run, FedHQ on a 4-device 2-cell hierarchy, and one round of
AnycostFL on vgg9-cifar (2 devices, n_train 64; the fleet's budgets
scaled with the model's per-sample work, 12.6 times fmnist-cnn's, since
on the default budgets no device finds a feasible strategy).

Tolerances: strategies, widths, tiers, FedHQ level counts, data draws and
the numpy stream exact; bits, costs and losses rtol 1e-5 (float32 sums
in another order; the uplink share of the round's latency, a difference
of two latencies, within 1e-5 of the latency); accuracy within 0.02;
each round's new parameters within 1e-3 of the round's update norm (a
level index can flip where a float32 sum lands on a grid boundary).  The
top-k methods (STC, QSGD, UVeQFed) keep an element by its own magnitude,
so the float32 difference of the local training can also swap an
element at the top-k boundary, which moves an aggregated coordinate
covered by one device by a whole kept value: for them the 1e-3 holds
outside the ``TOPK_SWAPS`` most distant coordinates of each round.  The
compressors themselves agree exactly on the same inputs
(``tests/test_torch_baselines.py``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import topology as jtopo  # noqa: E402
from repro.orchestrator import runner as jrunner  # noqa: E402
from repro.orchestrator.policies import OrchestratorConfig as JOrch  # noqa: E402
from repro.orchestrator.policies import make_policy  # noqa: E402
from repro.sysmodel.population import FleetConfig as JFleet  # noqa: E402
from repro.train.fl_loop import FLRunConfig as JRunConfig  # noqa: E402
from repro.utils.pytree import flatten_to_vector  # noqa: E402
from repro_torch import bridge, topology  # noqa: E402
from repro_torch.orchestrator import policies, runner  # noqa: E402
from repro_torch.sysmodel.population import (VGG9_BUDGETS,  # noqa: E402
                                             FleetConfig)
from repro_torch.train.fl_loop import METHODS, FLRunConfig  # noqa: E402
from test_torch_fl import JaxKeyChain  # noqa: E402

torch.set_num_threads(1)

TINY = dict(rounds=2, n_train=128, n_test=64, eval_every=1, lr=0.1,
            batch_size=32, seed=3, use_planner=False)
BASELINES = METHODS[1:]
TOPK_SWAPS = 4
#: case -> (run config overrides, fleet keywords, hierarchical cells)
CASES = {
    **{m: (dict(method=m, use_planner=True), dict(n_devices=3), None)
       for m in BASELINES},
    "no_ems": (dict(use_ems=False), dict(n_devices=3), None),
    "no_fgc": (dict(use_fgc=False), dict(n_devices=3), None),
    "no_aio": (dict(use_aio=False), dict(n_devices=3), None),
    "non_iid": (dict(iid=False), dict(n_devices=3), None),
    "fedhq_hier": (dict(method="fedhq"), dict(n_devices=4), 2),
    "vgg9_cifar": (dict(arch="vgg9-cifar", rounds=1, n_train=64),
                   dict(n_devices=2, **VGG9_BUDGETS), None),
}


def _record(sim, prepares, updates, evals):
    prep, mat, ev = sim.prepare, sim.materialize, sim.evaluate

    def prepare(i, env):
        p = prep(i, env)
        if p is not None:
            prepares.append((i, p.strat.alpha, p.strat.beta, p.strat.freq,
                             p.strat.gain, p.alpha,
                             np.asarray(p.batches["labels"]).copy()))
        return p

    def materialize(p, *a, **k):
        p = mat(p, *a, **k)
        updates.append((p.client_id, p.fedhq_level, p.update.alpha,
                        p.update.beta_target, p.update.n_samples,
                        p.update.bits, p.update.beta_realized))
        return p

    def evaluate(params):     # every round evaluates its new parameters
        evals.append(_flat(params))
        return ev(params)

    sim.prepare, sim.materialize, sim.evaluate = prepare, materialize, \
        evaluate


def _pair(case):
    over, fleet_kw, cells = CASES[case]
    jtop = ttop = None
    if cells is not None:
        jtop = jtopo.TopologyConfig(kind="hier", n_cells=cells)
        ttop = topology.TopologyConfig(kind="hier", n_cells=cells)
    jsim = jrunner.Simulation(JRunConfig(**dict(TINY, **over)),
                              JFleet(topology=jtop, **fleet_kw))
    init = jax.tree.map(np.asarray, jsim.params)
    j = dict(prep=[], upd=[], evals=[], start=[])
    _record(jsim, j["prep"], j["upd"], j["evals"])
    jsort = jsim.sort_params

    def sort_params(params):
        out = jsort(params)
        j["start"].append(jax.tree.map(np.asarray, out))
        return out

    jsim.sort_params = sort_params
    jorch = JOrch(policy="sync")
    j["hist"] = jrunner._run_round_based(
        jsim, make_policy(jorch, fleet_T_max=10.0), jorch, False)
    j["sim"] = jsim

    sim = runner.Simulation(FLRunConfig(**dict(TINY, **over)),
                            FleetConfig(topology=ttop, **fleet_kw),
                            device="cpu",
                            uniforms=JaxKeyChain(TINY["seed"] + 1))
    sim.params = bridge.params_from_numpy(init, "cpu")
    t = dict(prep=[], upd=[], evals=[])
    _record(sim, t["prep"], t["upd"], t["evals"])
    rounds = iter(j["start"])
    sim.sort_params = lambda params: bridge.params_from_numpy(next(rounds),
                                                              "cpu")
    orch = policies.OrchestratorConfig()
    t["hist"] = runner._run_round_based(sim, policies.SyncPolicy(orch),
                                        orch, False)
    t["sim"] = sim
    return dict(jax=j, torch=t)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _pair(case)
        return cache[case]

    return get


def _flat(tree):
    return np.asarray(flatten_to_vector(jax.tree.map(np.asarray, tree))[0])


@pytest.mark.parametrize("case", list(CASES))
def test_strategies_tiers_and_draws_match_exactly(runs, case):
    r = runs(case)
    j, t = r["jax"], r["torch"]
    assert len(t["prep"]) == len(j["prep"]) > 0
    for a, b in zip(t["prep"], j["prep"]):
        assert a[:6] == b[:6]
        np.testing.assert_array_equal(a[6], b[6])
    np.testing.assert_array_equal(t["sim"].tiers, j["sim"].tiers)
    assert t["sim"].rng.bit_generator.state == \
        j["sim"].rng.bit_generator.state
    assert (t["sim"].planner is None) == (j["sim"].planner is None)
    assert len(t["upd"]) == len(j["upd"])
    for a, b in zip(t["upd"], j["upd"]):
        assert a[:5] == b[:5]
        np.testing.assert_allclose(a[5:], b[5:], rtol=1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_round_logs_match(runs, case):
    r = runs(case)
    jrounds, trounds = r["jax"]["hist"].rounds, r["torch"]["hist"].rounds
    assert len(trounds) == len(jrounds) == CASES[case][0].get(
        "rounds", TINY["rounds"])
    for t, j in zip(trounds, jrounds):
        for f in ("mean_alpha", "mean_gain", "flops", "latency_train_s",
                  "energy_train_j", "n_clients", "n_dropped",
                  "n_cells_reporting", "backhaul_bits"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("latency_s", "energy_j", "comm_bits", "mean_beta",
                  "t_wall", "energy_uplink_j", "test_loss"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                       rtol=1e-5, err_msg=f)
        assert abs(t.latency_uplink_s - j.latency_uplink_s) \
            <= 1e-5 * j.latency_s
        assert abs(t.test_acc - j.test_acc) <= 0.02


@pytest.mark.parametrize("case", list(CASES))
def test_round_params_match(runs, case):
    r = runs(case)
    j, t = r["jax"], r["torch"]
    assert len(t["evals"]) == len(j["evals"]) == len(j["start"]) > 0
    swaps = TOPK_SWAPS if CASES[case][0].get("method") in (
        "stc", "qsgd", "uveqfed") else 0
    for start, want, got in zip(j["start"], j["evals"], t["evals"]):
        assert np.isfinite(got).all()
        dist = np.sort(np.abs(got - want))[:got.size - swaps]
        assert np.linalg.norm(dist) \
            <= 1e-3 * np.linalg.norm(want - _flat(start))


def test_the_table1_runs_cover_every_method_and_ablation():
    methods = {c[0].get("method", "anycostfl") for c in CASES.values()}
    assert methods == set(METHODS)
    off = {k for c in CASES.values() for k, v in c[0].items() if v is False}
    assert off == {"use_ems", "use_fgc", "use_aio", "iid"}


def test_baseline_runs_fit_no_planner_and_fgc_off_still_fits_it(
        monkeypatch):
    """The planner is AnycostFL's alone, with or without FGC: a baseline
    takes no planner draw from the uniform source and no probe
    permutation from the numpy stream."""
    fits = []
    monkeypatch.setattr(runner.compression.BetaPlanner, "fit",
                        staticmethod(lambda upd, rand: fits.append(1)))
    for over, want in ((dict(method="qsgd"), 0), (dict(use_fgc=False), 1)):
        fits.clear()
        sim = runner.Simulation(
            FLRunConfig(**dict(TINY, use_planner=True, **over)),
            FleetConfig(n_devices=3), device="cpu")
        state = sim.rng.bit_generator.state
        sim.ensure_planner(sim.sort_params(sim.params))
        assert len(fits) == want
        assert (sim.rng.bit_generator.state == state) == (want == 0)
    with pytest.raises(ValueError, match="method"):
        runner.Simulation(dataclasses.replace(FLRunConfig(**TINY),
                                              method="fedprox"),
                          device="cpu")
