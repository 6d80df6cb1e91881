"""The client pool and the semisync and fedbuff policies in the port,
against the reference.

The live runs take the reference's TINY config (``tests/test_orchestrator.py``:
2 rounds, n_train 128, seed 3, no planner), 3 devices, fmnist-cnn at full
width, in the JAX package and in the port; the port starts from the
reference's initial parameters and replays the reference's JAX key chain
as its uniform source (as ``tests/test_torch_fl.py`` does).  Both sides
train through their client pools (vmapped per width bucket), so their
convolutions sum in other orders than each other's.

Tolerances:
- the policy helpers bitwise; the semisync partition exact;
- the pool's trained parameters within rtol 1e-5 of the per-client
  loop's, elementwise beside an absolute 1e-5 of the leaf's largest
  magnitude (a vmapped convolution sums in another order, an error set by
  the summed terms, not by the result); against the reference pool's,
  within 1e-3 of the local update's norm, as ``tests/test_torch_fl.py``
  holds a round's parameters (XLA's and PyTorch's convolution sums can
  tip a near-tie of a max-pool window, which routes one gradient
  elsewhere: seen at 3.0e-4 of the norm on these inputs); the same jobs
  through the lanes' batched GEMMs that the pool runs on a card, in
  float64 on both sides, to the same tolerances;
- semisync, flat and on a 4-device 2-cell hierarchy: the clients
  accepted and dropped and the cells reporting exact, and the flat
  round's latency (the binding deadline); energy, bits, losses and the
  hierarchical round's latency (a cell whose arrivals all made the
  deadline waits for its last one) rtol 1e-4 (the reference's own
  tolerance between its pooled and sequential runs);
- fedbuff: the event trace, the clients and staleness of every merge, the
  stale drops and the peak in-flight count exact (the timeline reads
  planned costs only); energy and bits rtol 1e-4; losses rtol 1e-3 (the
  reference's tolerance between its pooled and sequential fedbuff runs).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import topology as jtopology  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import shrinking as jshrinking  # noqa: E402
from repro.core.anycost import AnycostClient as JClient  # noqa: E402
from repro.models.registry import build_model as jbuild_model  # noqa: E402
from repro.orchestrator import client_pool as jpool  # noqa: E402
from repro.orchestrator import policies as jpolicies  # noqa: E402
from repro.orchestrator import runner as jrunner  # noqa: E402
from repro.sysmodel import population as jpopulation  # noqa: E402
from repro.sysmodel.population import FleetConfig as JFleet  # noqa: E402
from repro.train.fl_loop import FLRunConfig as JRunConfig  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import shrinking  # noqa: E402
from repro_torch.core.anycost import AnycostClient  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import cnn_lanes  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.orchestrator import client_pool, policies  # noqa: E402
from repro_torch.orchestrator import runner  # noqa: E402
from repro_torch.sysmodel import population  # noqa: E402
from repro_torch.sysmodel.population import FleetConfig  # noqa: E402
from repro_torch.topology import TopologyConfig  # noqa: E402
from repro_torch.train.fl_loop import FLRunConfig  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402
from test_torch_fl import TINY, JaxKeyChain  # noqa: E402

torch.set_num_threads(1)

#: live run -> OrchestratorConfig keywords, the same on both sides
CASES = {
    "semisync_drop": dict(policy="semisync", deadline_s=10.5,
                          straggler_mode="drop", use_pool=True),
    "semisync_downweight": dict(policy="semisync", deadline_s=10.5,
                                straggler_mode="downweight", use_pool=True),
    "fedbuff": dict(policy="fedbuff", buffer_size=2, max_wallclock_s=30.0),
    "fedbuff_requeue": dict(policy="fedbuff", buffer_size=2,
                            max_wallclock_s=60.0, staleness_cap=1,
                            staleness_mode="requeue"),
    "fedbuff_inflight": dict(policy="fedbuff", buffer_size=2,
                             max_wallclock_s=30.0, max_inflight=2),
}
#: semisync on a 4-device, 2-cell hierarchy: each edge applies the
#: deadline to its own arrivals
HIER_CASES = {"semisync_hier": dict(policy="semisync", deadline_s=10.5,
                                    straggler_mode="drop", use_pool=True)}
FEDBUFF = [c for c in CASES if c.startswith("fedbuff")]
SEMISYNC = [c for c in CASES if c.startswith("semisync")] + list(HIER_CASES)


def _pair(case):
    kw = CASES.get(case) or HIER_CASES[case]
    cells = 2 if case in HIER_CASES else None
    jfleet = JFleet(n_devices=3) if cells is None else JFleet(
        n_devices=4, topology=jtopology.TopologyConfig(kind="hier",
                                                       n_cells=cells))
    fleet = FleetConfig(n_devices=3) if cells is None else FleetConfig(
        n_devices=4, topology=TopologyConfig(kind="hier", n_cells=cells))
    jsim = jrunner.Simulation(JRunConfig(**TINY), jfleet)
    init = jax.tree.map(np.asarray, jsim.params)
    jorch = jpolicies.OrchestratorConfig(**kw)
    jpol = jpolicies.make_policy(jorch, fleet_T_max=10.0)
    jrun = jrunner._run_round_based if jpol.round_based \
        else jrunner._run_fedbuff
    jhist = jrun(jsim, jpol, jorch, False)

    sim = runner.Simulation(FLRunConfig(**TINY), fleet, device="cpu",
                            uniforms=JaxKeyChain(TINY["seed"] + 1))
    sim.params = bridge.params_from_numpy(init, "cpu")
    orch = policies.OrchestratorConfig(**kw)
    pol = policies.make_policy(orch, fleet_T_max=10.0)
    run = runner._run_round_based if pol.round_based else runner._run_fedbuff
    hist = run(sim, pol, orch, False)
    return dict(jax=jhist, torch=hist, jsim=jsim, sim=sim)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _pair(case)
        return cache[case]

    return get


# ------------------------------------------------------------ policy helpers

@pytest.mark.parametrize("staleness", [[0, 0, 0], [0, 3, 7], [0, 0, 0, 50],
                                       [1, 2]])
@pytest.mark.parametrize("gamma", [0.5, 1.0, 0.3])
def test_staleness_helpers_match_the_reference_bitwise(staleness, gamma):
    rng = np.random.default_rng(len(staleness))
    base = rng.uniform(0.1, 1.0, len(staleness)).astype(np.float32)
    base /= base.sum()
    assert policies.staleness_scales(staleness, gamma) == \
        jpolicies.staleness_scales(staleness, gamma)
    got = policies.staleness_scaled_weights(torch.tensor(base), staleness,
                                            gamma).numpy()
    want = np.asarray(jpolicies.staleness_scaled_weights(
        jax.numpy.asarray(base), staleness, gamma))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["drop", "downweight"])
@pytest.mark.parametrize("deadline", [None, 4.0, 5.0, 1e9])
def test_semisync_accept_partitions_as_the_reference(mode, deadline):
    class P:
        def __init__(self, d):
            self.duration = d

    durations = [3.0, 6.0, 4.0, 5.0, 12.5, 0.5]
    out = []
    for mod in (policies, jpolicies):
        pol = mod.SemiSyncPolicy(mod.OrchestratorConfig(
            policy="semisync", deadline_s=deadline, straggler_mode=mode,
            straggler_weight=0.1), fleet_T_max=10.0)
        acc, scales, lat = pol.accept([P(d) for d in durations], 0.0)
        out.append(([p.duration for p in acc], scales, lat))
    assert out[0] == out[1]


@pytest.mark.parametrize("kw", [
    dict(policy="async"), dict(straggler_mode="defer"),
    dict(staleness_mode="defer"), dict(staleness_cap=-1),
    dict(max_inflight=0), dict(event_trace_limit=0),
    dict(agg_route="ring")])
def test_orchestrator_config_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError):
        jpolicies.OrchestratorConfig(**kw)
    with pytest.raises(ValueError):
        policies.OrchestratorConfig(**kw)


def test_policies_are_the_reference_ones():
    for name in ("sync", "semisync", "fedbuff"):
        cfg = policies.OrchestratorConfig(policy=name)
        pol = policies.make_policy(cfg, fleet_T_max=10.0)
        jpol = jpolicies.make_policy(jpolicies.OrchestratorConfig(
            policy=name), fleet_T_max=10.0)
        assert (pol.name, pol.round_based, pol.pool_default) == \
            (jpol.name, jpol.round_based, jpol.pool_default)
    fb = policies.FedBuffPolicy(policies.OrchestratorConfig(
        policy="fedbuff", staleness_cap=1, buffer_size=2))
    assert [fb.admit(s) for s in range(3)] == [True, True, False]
    assert not fb.should_aggregate([0]) and fb.should_aggregate([0, 1])


def test_fedbuff_on_a_hierarchy_raises_as_the_reference():
    with pytest.raises(ValueError, match="round-based"):
        runner.run_orchestrated(
            FLRunConfig(**TINY),
            FleetConfig(n_devices=2, topology=TopologyConfig(kind="hier",
                                                             n_cells=2)),
            policies.OrchestratorConfig(policy="fedbuff"), device="cpu")


@pytest.mark.parametrize("n_cells", [None, 2])
def test_device_env_draws_as_the_reference(n_cells):
    """One device's fresh channel draw: the same env and the same numpy
    stream position as the reference's, flat and per cell."""
    fleets = []
    for mod, topo in ((population, TopologyConfig),
                      (jpopulation, jtopology.TopologyConfig)):
        cfg = mod.FleetConfig(n_devices=4, topology=None if n_cells is None
                              else topo(kind="hier", n_cells=n_cells))
        rng = np.random.default_rng(5)
        fleet = mod.make_fleet(rng, cfg, np.array([40, 30, 20, 10]))
        envs = [dataclasses.astuple(fleet.device_env(rng, i, 1e6, 3.2e7))
                for i in (2, 0, 3, 2)]
        fleets.append((envs, rng.bit_generator.state))
    (envs, state), (jenvs, jstate) = fleets
    assert envs == jenvs and state == jstate


# --------------------------------------------------------------- client pool

def _pool_setup(seed=0):
    """The port's and the reference's clients over one fmnist-cnn, the
    reference's initial parameters sorted, and five jobs: two in the 0.55
    bucket, two at full width, one alone at 0.25, interleaved."""
    cfg = get_config("fmnist-cnn")
    jcfg = jget_config("fmnist-cnn")
    jmodel = jbuild_model(jcfg)
    jspec = jshrinking.cnn_shrink_spec(jcfg)
    jparams = jshrinking.sort_channels(
        jmodel.init(jax.random.PRNGKey(seed)), jspec)
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    client = AnycostClient(build_model(cfg), shrinking.cnn_shrink_spec(cfg),
                           lr=0.1, batch_size=8)
    jclient = JClient(jmodel, jspec, lr=0.1, batch_size=8)
    rng = np.random.default_rng(seed)
    alphas = [0.55, 1.0, 0.55, 0.25, 1.0]
    batches = [dict(images=rng.standard_normal((2, 8, 28, 28, 1)).astype(
        np.float32), labels=rng.integers(0, 10, (2, 8)).astype(np.int32))
        for _ in alphas]
    return client, jclient, params, jparams, alphas, batches


def _assert_close(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max())


def _flat(tree):
    return np.concatenate([np.asarray(x).ravel() for x in tree_leaves(tree)])


def _assert_near_reference(got, want, start):
    want, start = _flat(want), _flat(start)
    assert np.linalg.norm(_flat(got) - want) \
        <= 1e-3 * np.linalg.norm(want - start)


def _pool_against_loop_and_reference(stacked, dtype=np.float32):
    client, jclient, params, jparams, alphas, batches = _pool_setup()
    if dtype != np.float32:
        params = tree_map(lambda x: x.to(torch.float64), params)
        jparams = jax.tree.map(lambda x: x.astype(dtype), jparams)
        batches = [dict(b, images=b["images"].astype(dtype))
                   for b in batches]
    pool, jp = client_pool.ClientPool(client), jpool.ClientPool(jclient)
    tb = [{k: torch.tensor(v) for k, v in b.items()} for b in batches]
    jb = [{k: jax.numpy.asarray(v) for k, v in b.items()} for b in batches]
    if stacked:
        # each job from its own version: the global model moved by j steps
        subs = [shrinking.shrink(tree_map(
            lambda x, j=j: x * (1.0 - 0.01 * j), params), a, client.spec)
            for j, a in enumerate(alphas)]
        jsubs = [jax.tree.map(jax.numpy.asarray,
                              bridge.params_to_numpy(s)) for s in subs]
        got = pool.train_stacked([client_pool.TrainJob(
            i, a, b, sub_params=s) for i, (a, b, s) in enumerate(
                zip(alphas, tb, subs))])
        want = jp.train_stacked([jpool.TrainJob(
            i, a, b, sub_params=s) for i, (a, b, s) in enumerate(
                zip(alphas, jb, jsubs))])
    else:
        subs = [shrinking.shrink(params, a, client.spec) for a in alphas]
        got = pool.train_shared(params, [client_pool.TrainJob(i, a, b)
                                         for i, (a, b) in enumerate(
                                             zip(alphas, tb))])
        want = jp.train_shared(jparams, [jpool.TrainJob(i, a, b)
                                         for i, (a, b) in enumerate(
                                             zip(alphas, jb))])
    assert len(got) == len(alphas)
    for g, w, s, b in zip(got, want, subs, tb):
        assert all(x.dtype == np.dtype(dtype) for x in tree_leaves(w))
        _assert_close(g, client._local_steps(s, b))
        _assert_near_reference(g, w, s)


@pytest.mark.parametrize("stacked", [False, True])
def test_client_pool_matches_the_loop_and_the_reference_pool(stacked):
    _pool_against_loop_and_reference(stacked)


@pytest.mark.parametrize("stacked", [False, True])
def test_the_cards_lane_gemms_match_the_loop_and_the_reference_pool(
        monkeypatch, stacked):
    """The same jobs through the convolutions the pool runs on a card
    (``cnn_lanes``' batched GEMMs), both sides in float64: in float32 the
    GEMMs' rounding tips units at a ReLU's zero or a pool's runner-up
    that the loop's convolution does not (1.3e-2 of an update)."""
    monkeypatch.setattr(cnn_lanes, "_gemm", lambda x: True)
    with jax.enable_x64(True):
        _pool_against_loop_and_reference(stacked, np.float64)


# ------------------------------------------------------------------ semisync

@pytest.mark.parametrize("case", SEMISYNC)
def test_semisync_matches_the_reference(runs, case):
    r = runs(case)
    trounds, jrounds = r["torch"].rounds, r["jax"].rounds
    assert len(trounds) == len(jrounds) == TINY["rounds"]
    for t, j in zip(trounds, jrounds):
        assert (t.n_clients, t.n_dropped, t.n_cells_reporting) == \
            (j.n_clients, j.n_dropped, j.n_cells_reporting)
        if case in HIER_CASES:   # a cell whose arrivals all made the
            # deadline waits for its last one, a realized (bits) time
            np.testing.assert_allclose(t.latency_s, j.latency_s, rtol=1e-4)
        else:
            assert t.latency_s == j.latency_s
        for f in ("energy_j", "comm_bits", "backhaul_bits", "test_loss"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                       rtol=1e-4, err_msg=f)
    if case != "semisync_downweight":      # the 10.5 s deadline binds
        assert sum(t.n_dropped for t in trounds) > 0
    ttrace, jtrace = r["torch"].trace, r["jax"].trace
    assert [e[1:] for e in ttrace] == [e[1:] for e in jtrace]
    np.testing.assert_allclose([e[0] for e in ttrace],
                               [e[0] for e in jtrace], rtol=1e-4)
    assert r["sim"].rng.bit_generator.state == \
        r["jsim"].rng.bit_generator.state


def test_semisync_with_an_unbinding_deadline_is_the_sync_run_bitwise():
    hists = [runner.run_orchestrated(
        FLRunConfig(**TINY), FleetConfig(n_devices=3), orch, device="cpu")
        for orch in (None, policies.OrchestratorConfig(
            policy="semisync", deadline_s=1e9, use_pool=False))]
    sync, semi = hists
    assert sync.best_acc == semi.best_acc
    for a, b in zip(sync.rounds, semi.rounds):
        assert (a.latency_s, a.energy_j, a.comm_bits, a.test_acc,
                a.test_loss, a.n_clients) == \
            (b.latency_s, b.energy_j, b.comm_bits, b.test_acc,
             b.test_loss, b.n_clients)
    for a, b in zip(tree_leaves(sync.final_params),
                    tree_leaves(semi.final_params)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------- fedbuff

@pytest.mark.parametrize("case", FEDBUFF)
def test_fedbuff_matches_the_reference(runs, case):
    r = runs(case)
    th, jh = r["torch"], r["jax"]
    assert th.trace == jh.trace and len(th.trace) > 0
    assert th.peak_inflight == jh.peak_inflight
    assert th.dispatch_log == jh.dispatch_log
    assert len(th.rounds) == len(jh.rounds) >= 2
    for t, j in zip(th.rounds, jh.rounds):
        for f in ("n_clients", "mean_staleness", "max_staleness",
                  "n_stale_dropped", "t_wall", "latency_s",
                  "latency_train_s", "mean_alpha", "mean_gain"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("energy_j", "comm_bits"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                       rtol=1e-4, err_msg=f)
        np.testing.assert_allclose(t.test_loss, j.test_loss, rtol=1e-3)
    assert r["sim"].rng.bit_generator.state == \
        r["jsim"].rng.bit_generator.state
    assert [tuple(x.shape) for x in tree_leaves(th.final_params)] == \
        [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(
            r["jsim"].params)]


def test_fedbuff_cases_exercise_their_options(runs):
    """Each live case reaches the branch it is there for: staleness above
    zero, the cap's rejections and requeues, the in-flight throttle."""
    free = runs("fedbuff")["torch"]
    assert any(r.mean_staleness > 0 for r in free.rounds)
    assert free.peak_inflight == 3
    capped = runs("fedbuff_requeue")["torch"]
    assert sum(r.n_stale_dropped for r in capped.rounds) > 0
    assert all(r.max_staleness <= 1 for r in capped.rounds)
    assert runs("fedbuff_inflight")["torch"].peak_inflight == 2


def test_fedbuff_without_the_pool_keeps_the_timeline():
    """``use_pool=False`` trains the buffer one client at a time: the
    timeline reads planned costs only, so the trace and the staleness are
    the pooled run's exactly; losses rtol 1e-3."""
    hists = [runner.run_orchestrated(
        FLRunConfig(**TINY), FleetConfig(n_devices=3),
        policies.OrchestratorConfig(**dict(CASES["fedbuff"],
                                           use_pool=pool)), device="cpu")
        for pool in (True, False)]
    pooled, seq = hists
    assert pooled.trace == seq.trace
    assert [(r.n_clients, r.mean_staleness) for r in pooled.rounds] == \
        [(r.n_clients, r.mean_staleness) for r in seq.rounds]
    np.testing.assert_allclose([r.test_loss for r in seq.rounds],
                               [r.test_loss for r in pooled.rounds],
                               rtol=1e-3)


def test_cli_runs_fedbuff_on_the_cpu(capsys):
    launch_train.main(["--mode", "fl", "--async-mode", "fedbuff",
                       "--device", "cpu", "--devices", "3", "--rounds", "2",
                       "--buffer-size", "2", "--n-train", "128",
                       "--n-test", "64", "--eval-every", "1", "--seed", "3"])
    out = capsys.readouterr().out
    blob = json.JSONDecoder().raw_decode(out, out.index("{"))[0]
    assert blob["policy"] == "fedbuff" and blob["method"] == "anycostfl"
    assert blob["rows"]["round"] == 1 and blob["rows"]["n_clients"] == 2
    assert blob["sim_wallclock_s"] > 0
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--async-mode", "fedbuff", "--devices", "2",
                               "--rounds", "1"])
