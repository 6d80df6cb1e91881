"""Fleet dynamics in the port (availability, battery, selection, churn),
against the reference.

The unit tests feed the same seeds and the same queries to
``repro.fleet`` and ``repro_torch.fleet`` and hold the answers equal bit
for bit: the traces' state and ``next_change`` over a grid of
``(device, time)`` (the boundaries themselves included), the batteries
under one sequence of debits, each selection policy's cohorts over
several rounds and the generator state after them, and the config
checks, which raise where the reference raises.

The end-to-end tests take the reference tests' TINY config
(``tests/test_fleet.py``: 6 devices, n_train 128, 3 rounds, seed 3, no
planner), one client at a time on both sides, and run the reference and
the port from the same initial parameters with the reference's JAX key
chain as the port's uniform source (``tests/test_torch_fl.py``).  Exact:
the event trace's order, kinds and clients, the dispatch log's devices,
every round's ``n_clients``, ``n_dropped``, ``n_unavailable``,
``n_aborted``, ``n_handovers``, ``max_cell_occupancy`` and cells
reporting, and the numpy stream.  Under fedbuff the timeline reads
planned costs only, so the trace and the dispatch log (times and
headroom) are exact too.  Rtol 1e-5 in round 0, which both sides start
from one model: bits, energy, losses, and, in the round-based runs,
every time and state of charge (the round's latency is the realized
uplink time, float32 sums in another order).  From round 1 on, rtol
``LATER_RTOL``: a level index that flips where a float32 sum lands on a
grid boundary (ROADMAP §3) moves the next round's start by a whole
quantization step, and with the small ``beta`` of the SoC-deadline run
that read 5.8e-5 in a loss and 4.0e-5 in a round's bits.  One semisync
run trains through both sides' client pools.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import fleet as jfleet  # noqa: E402
from repro import mobility as jmobility  # noqa: E402
from repro import topology as jtopology  # noqa: E402
from repro.orchestrator import policies as jpolicies  # noqa: E402
from repro.orchestrator import runner as jrunner  # noqa: E402
from repro.sysmodel import population as jpopulation  # noqa: E402
from repro.train.fl_loop import FLRunConfig as JRunConfig  # noqa: E402
from repro_torch import bridge, fleet, mobility, topology  # noqa: E402
from repro_torch.orchestrator import policies, runner  # noqa: E402
from repro_torch.sysmodel import population  # noqa: E402
from repro_torch.train.fl_loop import FLRunConfig  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402
from test_torch_fl import JaxKeyChain  # noqa: E402

torch.set_num_threads(1)

TINY = dict(rounds=3, n_train=128, n_test=64, eval_every=1, lr=0.1,
            batch_size=32, seed=3, use_planner=False)
LATER_RTOL = 1e-4
#: each side's namespace, so one function makes both sides' configs
SIDES = {
    "jax": dict(fleet=jfleet, mobility=jmobility, topology=jtopology,
                population=jpopulation),
    "torch": dict(fleet=fleet, mobility=mobility, topology=topology,
                  population=population)}


# ------------------------------------------------------ end-to-end harness

def run_pair(fleet_kw, orch_kw, run_kw=None):
    """One live run in the reference and one in the port.  ``fleet_kw``
    maps a side's namespace to its ``FleetConfig`` keywords; the port
    starts from the reference's initial parameters and replays its key
    chain."""
    run_kw = dict(TINY, **(run_kw or {}))
    out = {}
    jsim = jrunner.Simulation(JRunConfig(**run_kw), jpopulation.FleetConfig(
        **fleet_kw(SIDES["jax"])))
    init = jax.tree.map(np.asarray, jsim.params)
    jorch = jpolicies.OrchestratorConfig(**orch_kw)
    jpol = jpolicies.make_policy(jorch, fleet_T_max=10.0)
    jrun = jrunner._run_round_based if jpol.round_based \
        else jrunner._run_fedbuff
    out["jax"], out["jsim"] = jrun(jsim, jpol, jorch, False), jsim
    sim = runner.Simulation(FLRunConfig(**run_kw), population.FleetConfig(
        **fleet_kw(SIDES["torch"])), device="cpu",
        uniforms=JaxKeyChain(run_kw["seed"] + 1))
    sim.params = bridge.params_from_numpy(init, "cpu")
    orch = policies.OrchestratorConfig(**orch_kw)
    pol = policies.make_policy(orch, fleet_T_max=10.0)
    run = runner._run_round_based if pol.round_based else runner._run_fedbuff
    out["torch"], out["sim"] = run(sim, pol, orch, False), sim
    out["round_based"] = pol.round_based
    return out


EXACT = ("n_clients", "n_dropped", "n_unavailable", "n_aborted",
         "n_handovers", "max_cell_occupancy", "n_cells_reporting",
         "n_stale_dropped")
CLOSE = ("energy_j", "comm_bits", "backhaul_bits", "test_loss",
         "energy_train_j", "energy_uplink_j")
TIMES = ("t_wall", "latency_s", "mean_soc", "t_max_effective")


def assert_runs_match(r):
    """The port's run against the reference's, as the module docstring
    states."""
    th, jh = r["torch"], r["jax"]
    if r["round_based"]:
        assert [e[1:] for e in th.trace] == [e[1:] for e in jh.trace]
        np.testing.assert_allclose([e[0] for e in th.trace],
                                   [e[0] for e in jh.trace], rtol=LATER_RTOL)
        assert [d[1] for d in th.dispatch_log] == \
            [d[1] for d in jh.dispatch_log]
        np.testing.assert_allclose(
            [(d[0], d[2]) for d in th.dispatch_log],
            [(d[0], d[2]) for d in jh.dispatch_log], rtol=LATER_RTOL)
    else:
        assert th.trace == jh.trace
        assert th.dispatch_log == jh.dispatch_log
        assert th.peak_inflight == jh.peak_inflight
    assert len(th.trace) > 0 and len(th.dispatch_log) > 0
    assert len(th.rounds) == len(jh.rounds) > 0
    for t, j in zip(th.rounds, jh.rounds):
        for f in EXACT:
            assert getattr(t, f) == getattr(j, f), (t.round, f)
        for f in CLOSE + TIMES:
            a, b = getattr(t, f), getattr(j, f)
            if f in TIMES and not r["round_based"]:
                assert a == b, (t.round, f)
            elif b is None:
                assert a is None, (t.round, f)
            else:
                np.testing.assert_allclose(
                    a, b, rtol=1e-5 if t.round == 0 else LATER_RTOL,
                    err_msg=f"{t.round} {f}")
    assert r["sim"].rng.bit_generator.state == \
        r["jsim"].rng.bit_generator.state


def kinds(hist) -> dict:
    """Events of each kind in a run's trace."""
    out: dict = {}
    for e in hist.trace:
        out[e[2]] = out.get(e[2], 0) + 1
    return out


def markov(ns, seed=0, on=30.0, off=15.0):
    return ns["fleet"].AvailabilityConfig(kind="markov", seed=seed,
                                          mean_on_s=on, mean_off_s=off)


#: live run -> (FleetConfig keywords per side, OrchestratorConfig keywords)
CASES = {
    # Markov availability, a battery, gain selection at participation
    # 0.5: every round trains, gates and aborts
    "sync_dynamics": (lambda ns: dict(n_devices=6, dynamics=ns[
        "fleet"].FleetDynamicsConfig(
            availability=markov(ns, seed=1),
            battery=ns["fleet"].BatteryConfig(capacity_j=30.0,
                                              recharge_w=0.2, seed=0),
            selection="gain", participation=0.5)),
        dict(policy="sync", use_pool=False)),
    # short on-times: rounds 0 and 1 train nobody, and the idle server
    # moves the clock a deadline on
    "empty_rounds": (lambda ns: dict(n_devices=6, dynamics=ns[
        "fleet"].FleetDynamicsConfig(
            availability=markov(ns, seed=2, on=8.0, off=6.0),
            battery=ns["fleet"].BatteryConfig(capacity_j=30.0,
                                              recharge_w=0.2, seed=0),
            selection="gain", participation=0.5)),
        dict(policy="sync", use_pool=False)),
    # the mean state of charge starts under the threshold: every round
    # solves for half the deadline
    "soc_deadline": (lambda ns: dict(n_devices=6, dynamics=ns[
        "fleet"].FleetDynamicsConfig(
            battery=ns["fleet"].BatteryConfig(
                capacity_j=30.0, init_frac=(0.3, 0.5), recharge_w=0.0,
                seed=5),
            soc_deadline_scale=0.5, soc_deadline_threshold=0.9)),
        dict(policy="sync", use_pool=False)),
    # no recharge: the fleet drains and the dispatches thin out
    "drained_battery": (lambda ns: dict(n_devices=6, dynamics=ns[
        "fleet"].FleetDynamicsConfig(battery=ns["fleet"].BatteryConfig(
            capacity_j=8.0, recharge_w=0.0, seed=5))),
        dict(policy="sync", use_pool=False)),
    # churn under a deadline barrier, oort's exploration at 0.5
    "semisync_churn": (lambda ns: dict(n_devices=6, dynamics=ns[
        "fleet"].FleetDynamicsConfig(
            availability=markov(ns, seed=3, on=12.0, off=6.0),
            selection="oort", participation=0.5)),
        dict(policy="semisync", deadline_s=10.0, straggler_mode="drop",
             use_pool=False)),
    # the same through both sides' client pools: aborted flights are
    # never handed to the pool
    "semisync_churn_pooled": (lambda ns: dict(n_devices=6, dynamics=ns[
        "fleet"].FleetDynamicsConfig(
            availability=markov(ns, seed=3, on=12.0, off=6.0),
            selection="oort", participation=0.5)),
        dict(policy="semisync", deadline_s=10.0, straggler_mode="drop",
             use_pool=True)),
    # fedbuff: CHURN at the planned arrival, RETRY at the trace's next
    # change or the battery's ready time, a stale flight requeued through
    # the gates
    "fedbuff_dynamics": (lambda ns: dict(n_devices=6, dynamics=ns[
        "fleet"].FleetDynamicsConfig(
            availability=markov(ns, seed=1, on=12.0, off=6.0),
            battery=ns["fleet"].BatteryConfig(capacity_j=20.0,
                                              recharge_w=0.1, seed=3))),
        dict(policy="fedbuff", buffer_size=2, max_wallclock_s=40.0,
             staleness_cap=0, staleness_mode="requeue", use_pool=False)),
}


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = run_pair(*CASES[case])
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_dynamic_runs_match_the_reference(runs, case):
    assert_runs_match(runs(case))


def test_dynamic_runs_exercise_their_branches(runs):
    """Each live case reaches what it is there for."""
    dyn = runs("sync_dynamics")["torch"]
    assert sum(r.n_unavailable for r in dyn.rounds) > 0
    assert sum(r.n_aborted for r in dyn.rounds) > 0
    assert all(r.n_clients > 0 for r in dyn.rounds)
    assert all(r.n_clients + r.n_dropped + r.n_aborted + r.n_unavailable
               <= 6 for r in dyn.rounds)
    empty = runs("empty_rounds")["torch"].rounds
    assert [r.n_clients for r in empty[:2]] == [0, 0]
    assert empty[1].t_wall - empty[0].t_wall == 10.0
    soc = runs("soc_deadline")["torch"]
    assert all(r.t_max_effective == 5.0 for r in soc.rounds)
    drained = runs("drained_battery")["torch"]
    assert drained.rounds[-1].n_clients < drained.rounds[0].n_clients
    assert drained.rounds[-1].mean_soc < drained.rounds[0].mean_soc
    assert all(head >= 0.5 - 1e-9 for _, _, head in drained.dispatch_log)
    semi = runs("semisync_churn")["torch"]
    assert sum(r.n_aborted for r in semi.rounds) > 0
    assert sum(r.n_dropped for r in semi.rounds) > 0
    assert all(r.latency_s <= 10.0 + 1e-9 for r in semi.rounds)
    assert all(r.n_clients + r.n_dropped + r.n_aborted <= 3
               for r in semi.rounds)
    fb = kinds(runs("fedbuff_dynamics")["torch"])
    assert fb.get("churn", 0) > 0 and fb.get("retry", 0) > 0
    fb_rounds = runs("fedbuff_dynamics")["torch"].rounds
    assert sum(r.n_aborted for r in fb_rounds) > 0
    assert sum(r.n_stale_dropped for r in fb_rounds) > 0


def test_default_dynamics_are_the_static_fleet_bitwise():
    """``FleetDynamicsConfig()`` (always on, no battery, uniform, no cap)
    gives the run with no dynamics bit for bit."""
    hists = [runner.run_orchestrated(
        FLRunConfig(**dict(TINY, rounds=2)), population.FleetConfig(
            n_devices=3, dynamics=dyn), policies.OrchestratorConfig(
                use_pool=False), device="cpu")
        for dyn in (None, fleet.FleetDynamicsConfig())]
    static, default = hists
    assert static.trace == default.trace
    assert static.dispatch_log == default.dispatch_log
    assert [dataclasses.asdict(r) for r in static.rounds] == \
        [dataclasses.asdict(r) for r in default.rounds]
    for a, b in zip(tree_leaves(static.final_params),
                    tree_leaves(default.final_params)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ availability

def _intervals():
    return [[[0.0, 5.0], [5.0, 9.0], [12.0, 20.5]], [[3.0, 7.0]],
            [[1.0, 4.0], [2.0, 6.0], [30.0, math.inf]]]


@pytest.fixture
def replay_files(tmp_path):
    """The legacy bare list, the ``{"devices": ...}`` form and the
    scenario schema (dicts, one without an ``on`` section)."""
    import json
    iv = _intervals()
    forms = {"bare": iv, "devices": {"devices": iv},
             "scenario": {"devices": [
                 {"waypoints": [[0, 0, 0]], "on": iv[0]},
                 {"on": iv[1]}, {"waypoints": [[0, 1, 1]]}]}}
    paths = {}
    for name, raw in forms.items():
        paths[name] = str(tmp_path / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(raw, f)
    return paths


def _grid(trace, n):
    """State and next change at a grid of times and at every boundary
    the grid's queries reveal (a flip time itself, and just before)."""
    out = []
    for i in range(n):
        for t in list(np.linspace(0.0, 150.0, 61)) + [1e4]:
            t = float(t)
            nxt = trace.next_change(i, t)
            out.append((i, t, trace.available(i, t), nxt))
            if math.isfinite(nxt):
                for tb in (nxt, math.nextafter(nxt, -math.inf)):
                    out.append((i, tb, trace.available(i, tb),
                                trace.next_change(i, tb)))
    return out


@pytest.mark.parametrize("cfg", [
    dict(kind="always"),
    dict(kind="markov", seed=0, mean_on_s=30.0, mean_off_s=15.0),
    dict(kind="markov", seed=7, mean_on_s=2.0, mean_off_s=9.0),
    dict(kind="diurnal", seed=0, period_s=120.0, duty=0.6),
    dict(kind="diurnal", seed=4, period_s=37.0, duty=0.25),
    dict(kind="diurnal", seed=1, duty=1.0),
    "bare", "devices", "scenario"])
def test_availability_traces_match_the_reference(cfg, replay_files):
    if isinstance(cfg, str):
        cfg = dict(kind="replay", trace_file=replay_files[cfg])
    n = 5
    jtr = jfleet.make_trace(jfleet.AvailabilityConfig(**cfg), n)
    ttr = fleet.make_trace(fleet.AvailabilityConfig(**cfg), n)
    assert type(ttr).__name__ == type(jtr).__name__
    assert _grid(ttr, n) == _grid(jtr, n)


def test_scenario_availability_matches_the_reference(replay_files):
    jtr = jmobility.ScenarioTrace.load(replay_files["scenario"]) \
        .availability(4)
    ttr = mobility.ScenarioTrace.load(replay_files["scenario"]) \
        .availability(4)
    assert _grid(ttr, 4) == _grid(jtr, 4)


# ------------------------------------------------------------------ battery

@pytest.mark.parametrize("cfg", [
    dict(), dict(capacity_j=30.0, recharge_w=0.2, seed=0),
    dict(capacity_j=8.0, recharge_w=0.0, seed=5, init_frac=(0.1, 0.4)),
    dict(capacity_j=20.0, reserve_frac=0.3, min_headroom_j=2.0, seed=9)])
def test_battery_sequences_match_the_reference(cfg):
    n = 6
    jb = jfleet.BatteryState(jfleet.BatteryConfig(**cfg), n)
    tb = fleet.BatteryState(fleet.BatteryConfig(**cfg), n)
    rng = np.random.default_rng(len(cfg))
    t, out = 0.0, []
    for _ in range(60):
        t += float(rng.exponential(3.0))
        i, e = int(rng.integers(n)), float(rng.uniform(-1.0, 9.0))
        for b in (jb, tb):
            b.debit(i, e, t)
        out.append([(b.soc_at(i, t), b.headroom(i, t), b.available(i, t),
                     b.ready_time(i, t), b.mean_soc_frac(t))
                    for b in (jb, tb)])
    for j, tt in out:
        assert j == tt
    np.testing.assert_array_equal(tb.soc, jb.soc)


# ---------------------------------------------------------------- selection

def _envs(ns, rnd, n=8):
    """Round ``rnd``'s envs of an n-device fleet, one seed for both
    sides."""
    rng = np.random.default_rng(100 + rnd)
    pop = ns["population"]
    f = pop.make_fleet(rng, pop.FleetConfig(n_devices=n),
                       np.full(n, 40))
    return f.round_envs(rng, 5.8e5, 3.2e7)


@pytest.mark.parametrize("name", ["uniform", "energy", "gain", "oort"])
@pytest.mark.parametrize("frac", [0.5, 0.25, 1.0])
def test_selection_policies_match_the_reference(name, frac):
    picks = {}
    for side, ns in SIDES.items():
        rng = np.random.default_rng([0x5E1EC7, 3])
        pol = ns["fleet"].make_selection(name, rng)
        got = []
        for rnd in range(6):
            envs = _envs(ns, rnd)
            # a changing roster: device rnd % 8 is off this round
            cand = [i for i in range(8) if i != rnd % 8]
            env_of = {i: envs[i] for i in cand}
            head = {i: float(envs[i].E_max) * (0.2 if i % 3 else 1.0)
                    for i in cand}
            cap = len(cand) if frac >= 1.0 \
                else max(1, math.ceil(frac * len(cand)))
            got.append(pol.select(cand, env_of, head, cap))
        picks[side] = (got, rng.bit_generator.state,
                       dict(getattr(pol, "n_selected", {})))
    assert picks["torch"] == picks["jax"]
    if frac >= 1.0 or name == "gain":
        # no binding cap, or a deterministic rank: no draw at all
        assert picks["torch"][1] == \
            np.random.default_rng([0x5E1EC7, 3]).bit_generator.state


# ------------------------------------------------------------ config checks

def _ctor(ns, name):
    return {"dyn": ns["fleet"].FleetDynamicsConfig,
            "avail": ns["fleet"].AvailabilityConfig,
            "battery": ns["fleet"].BatteryConfig,
            "markov": lambda **k: ns["fleet"].MarkovTrace(3, **k),
            "diurnal": lambda **k: ns["fleet"].DiurnalTrace(3, **k),
            "replay": lambda **k: ns["fleet"].ReplayTrace([], 3),
            "selection": lambda **k: ns["fleet"].make_selection(
                "best-effort", np.random.default_rng(0))}[name]


@pytest.mark.parametrize("name,kw", [
    ("dyn", dict(selection="best-effort")), ("dyn", dict(participation=0.0)),
    ("dyn", dict(participation=1.5)), ("dyn", dict(soc_deadline_scale=1.5)),
    ("dyn", dict(soc_deadline_scale=0.0)),
    ("dyn", dict(soc_deadline_threshold=-0.1)),
    ("avail", dict(kind="sometimes")), ("avail", dict(kind="replay")),
    ("battery", dict(reserve_frac=1.5)), ("battery", dict(capacity_j=0.0)),
    ("battery", dict(capacity_j=0.5, reserve_frac=0.2,
                     min_headroom_j=0.5)),
    ("markov", dict(mean_on_s=0.0)), ("diurnal", dict(period_s=0.0)),
    ("diurnal", dict(duty=0.0)), ("replay", {}), ("selection", {})])
def test_config_checks_raise_as_the_reference(name, kw):
    for ns in SIDES.values():
        with pytest.raises(ValueError):
            _ctor(ns, name)(**kw)


def test_make_fleet_draws_dynamics_apart_from_the_sampling_stream():
    """A fleet with dynamics consumes the sampling generator as one
    without, on both sides, and its trace and battery are the
    reference's."""
    states, fleets = [], {}
    for side, ns in SIDES.items():
        f = ns["fleet"]
        for dyn in (None, f.FleetDynamicsConfig(
                availability=markov(ns, seed=4),
                battery=f.BatteryConfig(seed=2))):
            rng = np.random.default_rng(9)
            fl = ns["population"].make_fleet(
                rng, ns["population"].FleetConfig(n_devices=5,
                                                  dynamics=dyn),
                np.full(5, 30))
            states.append(rng.bit_generator.state)
            fleets[side] = fl
    assert all(s == states[0] for s in states)
    jf, tf = fleets["jax"], fleets["torch"]
    np.testing.assert_array_equal(tf.battery.soc, jf.battery.soc)
    for t in (0.0, 7.5, 31.0, 90.0):
        assert [(tf.available(i, t), tf.next_departure(i, t))
                for i in range(5)] == \
            [(jf.available(i, t), jf.next_departure(i, t))
             for i in range(5)]
