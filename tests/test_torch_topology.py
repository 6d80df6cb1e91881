"""The port's hierarchical client -> edge -> cloud round, against the JAX
package on the CPU.

End to end: the reference's TINY config (2 rounds, n_train 128, no
planner), 4 devices in 2 cells at full fmnist-cnn width, run live in the
reference (``use_pool=False``) and in the port, with the port replaying
the reference's JAX key chain as its uniform source: (a) the ``f32``
streaming route over a costly backhaul, (b) the same with the ``int8``
codec and error feedback, (c) the ``batched`` route.  Each round the port
starts from the reference's sorted parameters (and EF frame): a float32
difference left by one round can flip a near-tie in the next round's
channel sort, which permutes the coordinate frame without changing the
model, and a per-round comparison needs one frame.

Tolerances, per round: strategies, data draws, cells reporting, backhaul
bits and the event order exact; costs, event times and test losses rtol
1e-5 (float32 sums in another order); the round's new parameters within
1e-3 of the round's update norm (a level index can flip where a float32
sum lands on a grid boundary).  Module checks on the same numpy inputs:
the partial monoid, the codec planes, cells, backhauls and per-cell
channel draws exact.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import topology as jtopo  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.orchestrator import runner as jrunner  # noqa: E402
from repro.orchestrator.policies import OrchestratorConfig as JOrch  # noqa: E402
from repro.orchestrator.policies import make_policy  # noqa: E402
from repro.sysmodel import population as jpop  # noqa: E402
from repro.sysmodel.wireless import WirelessConfig as JWireless  # noqa: E402
from repro.train.fl_loop import FLRunConfig as JRunConfig  # noqa: E402
from repro.utils.pytree import flatten_to_vector  # noqa: E402
from repro_torch import bridge, topology  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.orchestrator import policies, runner  # noqa: E402
from repro_torch.sysmodel import population  # noqa: E402
from repro_torch.sysmodel.wireless import WirelessConfig  # noqa: E402
from repro_torch.train.fl_loop import FLRunConfig  # noqa: E402
from repro_torch.utils import pytree  # noqa: E402

torch.set_num_threads(1)

TINY = dict(rounds=2, n_train=128, n_test=64, eval_every=1, lr=0.1,
            batch_size=32, seed=3, use_planner=False)
BACKHAUL = dict(rate_bps=1e8, latency_s=0.2, energy_per_bit=1e-10)
#: run name -> (backhaul codec keywords, aggregation route)
RUNS = {"f32_streaming": (dict(), "streaming"),
        "int8_ef_streaming": (dict(codec="int8", error_feedback=True),
                              "streaming"),
        "f32_batched": (dict(), "batched")}


class JaxKeyChain:
    """Replays the reference's key chain as the port's uniform source
    (as in ``tests/test_torch_fl.py``)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    @staticmethod
    def _draw(k):
        return lambda n: torch.tensor(np.array(jax.random.uniform(k, (n,))))

    def planner_stream(self):
        self.key, k1 = jax.random.split(self.key)
        return self._draw(k1)

    def device_stream(self):
        self.key, _, k2 = jax.random.split(self.key, 3)
        return self._draw(k2)


def _record(sim, prepares, evals):
    prep, ev = sim.prepare, sim.evaluate

    def prepare(i, env):
        p = prep(i, env)
        if p is not None:
            prepares.append((i, p.cell, p.strat.alpha, p.strat.beta,
                             p.strat.freq, p.alpha,
                             np.asarray(p.batches["labels"]).copy()))
        return p

    def evaluate(params):
        evals.append(params)
        return ev(params)

    sim.prepare, sim.evaluate = prepare, evaluate


def _flat(tree):
    return np.asarray(flatten_to_vector(jax.tree.map(np.asarray, tree))[0])


def _pair(codec_kw, route):
    topo = jtopo.TopologyConfig(
        kind="hier", n_cells=2,
        backhaul=jtopo.BackhaulConfig(**BACKHAUL, **codec_kw))
    jsim = jrunner.Simulation(JRunConfig(**TINY),
                              jpop.FleetConfig(n_devices=4, topology=topo))
    init = jax.tree.map(np.asarray, jsim.params)
    jprep, jevals, jsorted = [], [], []
    _record(jsim, jprep, jevals)
    jsort = jsim.sort_params

    def sort_params(params):
        out = jsort(params)
        jsorted.append((jax.tree.map(np.asarray, out), jsim._ef_frame))
        return out

    jsim.sort_params = sort_params
    jorch = JOrch(policy="sync", agg_route=route, use_pool=False)
    jsim.agg_route = jsim.resolve_agg_route(jorch.agg_route)
    jhist = jrunner._run_round_based(
        jsim, make_policy(jorch, fleet_T_max=10.0), jorch, False)

    ttopo = topology.TopologyConfig(
        kind="hier", n_cells=2,
        backhaul=topology.BackhaulConfig(**BACKHAUL, **codec_kw))
    sim = runner.Simulation(
        FLRunConfig(**TINY),
        population.FleetConfig(n_devices=4, topology=ttopo), device="cpu",
        uniforms=JaxKeyChain(TINY["seed"] + 1))
    sim.params = bridge.params_from_numpy(init, "cpu")
    tprep, tevals = [], []
    _record(sim, tprep, tevals)
    rounds = iter(jsorted)

    def forced_sort(params):
        sorted_np, frame = next(rounds)
        sim._ef_frame = frame
        return bridge.params_from_numpy(sorted_np, "cpu")

    sim.sort_params = forced_sort
    orch = policies.OrchestratorConfig(agg_route=route)
    sim.agg_route = sim.resolve_agg_route(orch.agg_route)
    hist = runner._run_round_based(sim, policies.SyncPolicy(orch), orch,
                                   False)
    return dict(jsim=jsim, jprep=jprep, jhist=jhist, sim=sim, tprep=tprep,
                hist=hist, start=[_flat(p) for p, _ in jsorted],
                jnew=[_flat(p) for p in jevals],
                tnew=[_flat(bridge.params_to_numpy(p)) for p in tevals])


@pytest.fixture(scope="module")
def runs():
    return {name: _pair(*spec) for name, spec in RUNS.items()}


@pytest.mark.parametrize("name", list(RUNS))
def test_hier_draws_cells_and_strategies_match_exactly(runs, name):
    r = runs[name]
    assert len(r["tprep"]) == len(r["jprep"]) > 0
    assert {p[1] for p in r["tprep"]} == {0, 1}
    for t, j in zip(r["tprep"], r["jprep"]):
        assert t[:6] == j[:6]
        np.testing.assert_array_equal(t[6], j[6])
    assert r["sim"].rng.bit_generator.state == \
        r["jsim"].rng.bit_generator.state


@pytest.mark.parametrize("name", list(RUNS))
def test_hier_round_logs_and_trace_match(runs, name):
    jrounds, trounds = runs[name]["jhist"].rounds, runs[name]["hist"].rounds
    assert len(trounds) == len(jrounds) == TINY["rounds"]
    for t, j in zip(trounds, jrounds):
        for f in ("mean_alpha", "mean_gain", "flops", "n_clients",
                  "n_dropped", "n_cells_reporting", "backhaul_bits"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("latency_s", "energy_j", "comm_bits", "mean_beta",
                  "t_wall", "energy_train_j", "energy_uplink_j",
                  "energy_backhaul_j", "latency_train_s",
                  "latency_uplink_s", "latency_backhaul_s", "test_loss"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                       rtol=1e-5, err_msg=f)
        assert t.n_cells_reporting == 2 and t.backhaul_bits > 0
    ttrace, jtrace = runs[name]["hist"].trace, runs[name]["jhist"].trace
    assert [e[1:] for e in ttrace] == [e[1:] for e in jtrace]
    assert sum(e[2] == "edge_merge" for e in ttrace) == 2 * TINY["rounds"]
    np.testing.assert_allclose([e[0] for e in ttrace],
                               [e[0] for e in jtrace], rtol=1e-5)


@pytest.mark.parametrize("name", list(RUNS))
def test_hier_round_params_match(runs, name):
    r = runs[name]
    assert len(r["tnew"]) == len(r["jnew"]) == TINY["rounds"]
    for start, want, got in zip(r["start"], r["jnew"], r["tnew"]):
        assert np.linalg.norm(got - want) \
            <= 1e-3 * np.linalg.norm(want - start)


def test_int8_backhaul_ships_a_quarter_of_the_f32_bits(runs):
    b32 = runs["f32_streaming"]["hist"].rounds[0].backhaul_bits
    b8 = runs["int8_ef_streaming"]["hist"].rounds[0].backhaul_bits
    assert b32 / b8 == pytest.approx(4.0, rel=0.01)


# ------------------------------------------------------------ module checks

def _tree(rng, scale=1.0):
    return {"a": {"w": (rng.standard_normal((3, 4)) * scale)
                  .astype(np.float32)},
            "b": (rng.standard_normal(5) * scale).astype(np.float32),
            "c": (rng.standard_normal((2, 2, 3)) * scale).astype(np.float32)}


def _masks(rng, tree):
    return jax.tree.map(lambda x: (rng.uniform(size=x.shape) > 0.4)
                        .astype(np.float32), tree)


def _t(tree):
    return bridge.params_from_numpy(tree, "cpu")


def test_partial_monoid_matches_reference():
    """Absorb, merge and finalize on flat planes against the reference's
    pytree monoid, exact (the same float32 operations per element).  The
    port's absorb and merge update the partial in place (the reference
    donates it), so the test reads the same partial afterwards."""
    rng = np.random.default_rng(21)
    template = _tree(rng)
    ups = [_tree(rng) for _ in range(5)]
    masks = [_masks(rng, u) for u in ups]
    ups[1]["b"][:] = 0.0          # a zero-valued update still counts in den
    ws = [0.7, 2.5, 1.25, 9.0, 0.3]
    ja, jb = jagg.partial_init(template), jagg.partial_init(template)
    ta, tb = aggregation.partial_init(_t(template)), \
        aggregation.partial_init(_t(template))
    ptr = ta.num.data_ptr()
    for i, (u, m, w) in enumerate(zip(ups, masks, ws)):
        if i < 3:
            ja = jagg.partial_absorb(ja, u, m, w)
            aggregation.partial_absorb(ta, _t(u), _t(m), w)
        else:
            jb = jagg.partial_absorb(jb, u, m, w)
            aggregation.partial_absorb(tb, _t(u), _t(m), w)
    # repro: ignore[use-after-donate] — the port folds in place
    assert ta.num.data_ptr() == ptr and (ta.count, tb.count) == (3, 2)
    # repro: ignore[use-after-donate] — the port folds in place
    np.testing.assert_array_equal(ta.num.numpy(), _flat(ja.num))
    # repro: ignore[use-after-donate] — the port folds in place
    np.testing.assert_array_equal(ta.den.numpy(), _flat(ja.den))
    jm = jagg.partial_merge(ja, jb)
    aggregation.partial_merge(ta, tb)
    assert ta.count == 5
    # repro: ignore[use-after-donate] — the port folds in place
    np.testing.assert_array_equal(ta.num.numpy(), _flat(jm.num))
    # repro: ignore[use-after-donate] — the port folds in place
    np.testing.assert_array_equal(ta.den.numpy(), _flat(jm.den))
    got = aggregation.partial_finalize(ta)
    assert [tuple(x.shape) for x in pytree.tree_leaves(got)] == \
        [x.shape for x in jax.tree_util.tree_leaves(template)]
    np.testing.assert_array_equal(
        _flat(bridge.params_to_numpy(got)), _flat(jagg.partial_finalize(jm)))


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_codec_planes_and_bits_match_reference(codec):
    rng = np.random.default_rng(22)
    template = _tree(rng)
    num, den = _tree(rng, 3.0), _tree(rng, 0.01)
    den["b"][:] = 0.0             # an all-zero leaf takes the 1e-30 floor
    jpart = jagg.PartialAgg(num=jax.tree.map(jnp.asarray, num),
                            den=jax.tree.map(jnp.asarray, den), count=3)
    tpart = aggregation.PartialAgg(
        num=torch.tensor(_flat(num)), den=torch.tensor(_flat(den)),
        template=_t(template), count=3)
    jenc = jtopo.encode_partial(jpart, codec)
    tenc = topology.encode_partial(tpart, codec)
    assert tenc.bits == jenc.bits and tenc.count == 3
    for got, want in ((tenc.num, jenc.num), (tenc.den, jenc.den)):
        np.testing.assert_array_equal(got.float().numpy(), _flat(want))
    if codec == "int8":
        for got, want in ((tenc.num_scale, jenc.num_scale),
                          (tenc.den_scale, jenc.den_scale)):
            np.testing.assert_array_equal(got.numpy(), _flat(want))
    if codec == "f32":            # the passthrough hands over the planes
        assert tenc.num is tpart.num and tenc.den is tpart.den
    jdec, tdec = jtopo.decode_partial(jenc), topology.decode_partial(tenc)
    np.testing.assert_array_equal(tdec.num.numpy(), _flat(jdec.num))
    np.testing.assert_array_equal(tdec.den.numpy(), _flat(jdec.den))


def test_cells_sites_and_backhauls_match_reference():
    for n, c, assignment in ((7, 3, "contiguous"), (7, 3, "round_robin"),
                             (12, 4, "contiguous"), (5, 1, "contiguous")):
        jt = jtopo.TopologyConfig(kind="hier", n_cells=c,
                                  assignment=assignment)
        tt = topology.TopologyConfig(kind="hier", n_cells=c,
                                     assignment=assignment)
        np.testing.assert_array_equal(topology.assign_cells(n, tt),
                                      jtopo.assign_cells(n, jt))
        np.testing.assert_array_equal(topology.cell_sites(c, 550.0),
                                      jtopo.cell_sites(c, 550.0))
        assert [w.cell_radius_m for w in tt.cell_wireless(WirelessConfig())] \
            == [w.cell_radius_m for w in jt.cell_wireless(JWireless())]
    base = dict(latency_s=0.05, energy_per_bit=2e-9, codec="bf16")
    got = topology.sample_cell_backhauls(
        topology.BackhaulConfig(**base), 5, (1e7, 1e10), seed=9)
    want = jtopo.sample_cell_backhauls(
        jtopo.BackhaulConfig(**base), 5, (1e7, 1e10), seed=9)
    for g, w in zip(got, want):
        assert (g.rate_bps, g.latency_s, g.codec) == \
            (w.rate_bps, w.latency_s, w.codec)
        assert g.ship_bits(3.3e6) == w.ship_bits(3.3e6)
        assert g.payload_bits(5e7) == w.payload_bits(5e7)
    tt = topology.TopologyConfig(kind="hier", n_cells=3,
                                 backhaul_rate_range=(1e7, 1e9),
                                 backhaul_het_seed=4)
    jt = jtopo.TopologyConfig(kind="hier", n_cells=3,
                              backhaul_rate_range=(1e7, 1e9),
                              backhaul_het_seed=4)
    assert [b.rate_bps for b in tt.cell_backhauls()] == \
        [b.rate_bps for b in jt.cell_backhauls()]
    for bad in (dict(kind="mesh"), dict(kind="flat", n_cells=2),
                dict(kind="hier", n_cells=0)):
        with pytest.raises(ValueError):
            topology.TopologyConfig(**bad)
    with pytest.raises(ValueError):
        topology.assign_cells(2, topology.TopologyConfig(kind="hier",
                                                         n_cells=3))


@pytest.mark.parametrize("n_cells", [1, 3])
def test_per_cell_round_envs_match_reference(n_cells):
    """Per-cell draws in ascending cell order; one cell takes the flat
    draw (the same stream, the same envs as no topology)."""
    a, b, c = (np.random.default_rng(6) for _ in range(3))
    sizes = np.array([11, 12, 13, 14, 15, 16, 17])
    jt = jtopo.TopologyConfig(kind="hier", n_cells=n_cells)
    tt = topology.TopologyConfig(kind="hier", n_cells=n_cells)
    jf = jpop.make_fleet(a, jpop.FleetConfig(n_devices=7, topology=jt),
                         sizes)
    tf = population.make_fleet(
        b, population.FleetConfig(n_devices=7, topology=tt), sizes)
    flat = population.make_fleet(c, population.FleetConfig(n_devices=7),
                                 sizes)
    assert tf.n_cells == jf.n_cells == n_cells
    assert [tf.cell_of(i) for i in range(7)] == \
        [jf.cell_of(i) for i in range(7)]
    for _ in range(2):
        tenvs = tf.round_envs(b, 1e6, 3.2e7)
        for je, te in zip(jf.round_envs(a, 1e6, 3.2e7), tenvs):
            assert dataclasses.asdict(je) == dataclasses.asdict(te)
        if n_cells == 1:
            assert [dataclasses.asdict(e) for e in tenvs] == \
                [dataclasses.asdict(e)
                 for e in flat.round_envs(c, 1e6, 3.2e7)]
    assert a.bit_generator.state == b.bit_generator.state


# ------------------------------------------------------------ port-only runs

def _port_run(topo=None, **orch):
    return runner.run_orchestrated(
        FLRunConfig(**TINY), population.FleetConfig(n_devices=4,
                                                    topology=topo),
        policies.OrchestratorConfig(**orch), device="cpu")


def test_one_cell_zero_cost_hierarchy_reproduces_the_flat_run():
    """Round 0 sees the same parameters, so its costs are bitwise equal;
    later rounds inherit the streaming fold's reordered float32 sums."""
    h_flat = _port_run()
    h_hier = _port_run(topology.TopologyConfig(
        kind="hier", n_cells=1,
        backhaul=topology.BackhaulConfig.zero_cost()))
    a0, b0 = h_flat.rounds[0], h_hier.rounds[0]
    assert (a0.latency_s, a0.energy_j, a0.comm_bits, a0.mean_alpha,
            a0.mean_beta) == (b0.latency_s, b0.energy_j, b0.comm_bits,
                              b0.mean_alpha, b0.mean_beta)
    for a, b in zip(h_flat.rounds, h_hier.rounds):
        assert a.latency_s == pytest.approx(b.latency_s, rel=1e-6)
        assert a.energy_j == pytest.approx(b.energy_j, rel=1e-6)
        assert a.comm_bits == pytest.approx(b.comm_bits, rel=1e-6)
        assert a.mean_alpha == b.mean_alpha
        assert a.test_loss == pytest.approx(b.test_loss, rel=1e-4)
    assert b0.n_cells_reporting == 1 and b0.backhaul_bits > 0
    assert a0.backhaul_bits == 0.0 and a0.n_cells_reporting == 0


def test_edge_error_feedback_drops_a_residual_from_another_frame():
    rng = np.random.default_rng(23)
    template = _t(_tree(rng))

    def part():
        return aggregation.PartialAgg(
            num=torch.tensor(_flat(_tree(rng, 5.0))),
            den=torch.tensor(_flat(_tree(rng, 0.1))), template=template)

    ef = topology.CodecErrorFeedback()
    p0 = part()
    enc = ef.encode_ship(0, p0, "int8", frame=("f",))
    res = p0.num - topology.decode_partial(enc).num
    p1 = part()
    want = topology.encode_partial(aggregation.PartialAgg(
        num=p1.num + res, den=p1.den, template=template), "int8")
    got = ef.encode_ship(0, p1, "int8", frame=("f",))
    assert torch.equal(got.num, want.num)
    p2 = part()
    moved = ef.encode_ship(0, p2, "int8", frame=("g",))
    assert torch.equal(moved.num,
                       topology.encode_partial(p2, "int8").num)
    assert ef.encode_ship(0, p2, "f32").num is p2.num


def test_cli_runs_the_hierarchy_on_the_cpu(capsys):
    launch_train.main(["--mode", "fl", "--device", "cpu", "--topology",
                       "hier", "--cells", "2", "--devices", "4", "--rounds",
                       "1", "--n-train", "64", "--n-test", "32",
                       "--eval-every", "1", "--backhaul-codec", "int8",
                       "--backhaul-ef"])
    out = capsys.readouterr().out
    blob = json.JSONDecoder().raw_decode(out, out.index("{"))[0]
    assert blob["topology"] == "hier" and blob["cells"] == 2
    assert blob["backhaul_mb"] > 0
    assert blob["rows"]["n_cells_reporting"] == 2
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--agg-route", "mesh"])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        policies.OrchestratorConfig(agg_route="mesh")
