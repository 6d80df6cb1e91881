"""Mobility in the port (motion models, handover, scenario traces), against
the reference.

The unit tests hold the port's ``repro_torch.mobility`` equal to the
reference's ``repro.mobility`` bit for bit: ``positions_at`` on a time
grid for every motion kind, ``HandoverEngine.reassign`` over a sequence
of rounds for every policy, the scenario trace's round trip, sections and
``backhaul_rate``, the mobile fleet's envs and numpy stream, and the
config checks, which raise where the reference raises.

The end-to-end tests run the reference and the port as
``tests/test_torch_fleet.py`` does (its harness and tolerances): a
mobile hierarchical run under each handover policy, a replay scenario
with an availability interval that ends mid-round and a backhaul rate
that steps down, and a flat mobile fedbuff run.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import mobility as jmobility  # noqa: E402
from repro_torch import mobility, topology  # noqa: E402
from test_torch_fleet import (SIDES, assert_runs_match, kinds,  # noqa: E402
                              run_pair)

torch.set_num_threads(1)


# ------------------------------------------------------------ motion models

MOTIONS = [
    dict(kind="random_waypoint", seed=0),
    dict(kind="random_waypoint", seed=7, speed_range=(20.0, 40.0)),
    dict(kind="random_waypoint", seed=3, hotspot=(100.0, -50.0),
         hotspot_frac=0.7, pause_range=(0.0, 0.0)),
    dict(kind="random_waypoint", seed=5, hotspot=(500.0, 0.0),
         hotspot_frac=1.0, hotspot_radius_m=200.0, area_radius_m=300.0),
    dict(kind="gauss_markov", seed=4, mean_speed=10.0),
    dict(kind="gauss_markov", seed=1, gm_alpha=0.0, tick_s=0.5,
         mean_speed=40.0, speed_sigma=8.0, area_radius_m=120.0),
]
TIMES = [0.0, 0.3, 1.0, 2.5, 7.0, 7.0, 19.99, 33.3, 120.0, 400.0]


@pytest.mark.parametrize("cfg", MOTIONS)
def test_positions_match_the_reference(cfg):
    jm = jmobility.make_motion(jmobility.MobilityConfig(**cfg), 6, 550.0)
    tm = mobility.make_motion(mobility.MobilityConfig(**cfg), 6, 550.0)
    assert type(tm).__name__ == type(jm).__name__
    for t in TIMES:
        np.testing.assert_array_equal(tm.positions_at(t), jm.positions_at(t))
    # and one device queried out of order
    for t in (250.0, 3.0, 60.0):
        np.testing.assert_array_equal(tm.position(2, t), jm.position(2, t))


def test_static_builds_no_motion_model():
    assert mobility.make_motion(mobility.MobilityConfig(), 4, 550.0) is None


def _scenario():
    """A 3-device, 2-site world: device 0 crosses from site 0's side to
    site 1's and leaves the cell at t = 8; device 1 stands still; device
    2 wanders; cell 0's backhaul steps down at t = 5 (its series out of
    order, as a merged log may hold it)."""
    return dict(
        devices=[
            {"waypoints": [[0, -120, 0], [10, 120, 0]], "on": [[0, 8]]},
            {"waypoints": [[0, 0, 40]]},
            {"waypoints": [[5, 30, 30], [0, -30, -30], [12, 60, -90]],
             "on": [[2, 4], [4, 9], [20, 30]]},
        ],
        cells=[
            {"site": [-100, 0], "backhaul_bps": [[5, 2e7], [0, 1e8]]},
            {"site": [100, 0]},
        ])


def test_scenario_trace_matches_the_reference(tmp_path):
    path = str(tmp_path / "scenario.json")
    mobility.ScenarioTrace(**_scenario()).save(path)
    with open(path) as f:
        assert json.load(f) == _scenario()
    scen, jscen = mobility.ScenarioTrace.load(path), \
        jmobility.ScenarioTrace.load(path)
    assert (scen.devices, scen.cells) == (jscen.devices, jscen.cells)
    assert (scen.has_mobility, scen.has_availability, scen.has_backhaul) \
        == (jscen.has_mobility, jscen.has_availability, jscen.has_backhaul) \
        == (True, True, True)
    np.testing.assert_array_equal(scen.sites(), jscen.sites())
    mob, jmob = scen.mobility(5), jscen.mobility(5)   # cycled over 5
    for t in TIMES:
        np.testing.assert_array_equal(mob.positions_at(t),
                                      jmob.positions_at(t))
    assert scen.availability_intervals() == jscen.availability_intervals()
    for k in range(4):
        for t in (-1.0, 0.0, 4.99, 5.0, 7.0, 1e9):
            assert scen.backhaul_rate(k, t) == jscen.backhaul_rate(k, t)
    assert [scen.backhaul_rate(0, t) for t in (0.0, 5.0)] == [1e8, 2e7]
    assert scen.backhaul_rate(1, 3.0) is None
    # the legacy bare availability list loads as availability only
    legacy = str(tmp_path / "legacy.json")
    with open(legacy, "w") as f:
        json.dump([[[0, 5]], [[1, 2]]], f)
    assert mobility.ScenarioTrace.load(legacy).devices == \
        jmobility.ScenarioTrace.load(legacy).devices
    assert mobility.ScenarioTrace.load(legacy).sites() is None


# ----------------------------------------------------------------- handover

@pytest.mark.parametrize("policy,margin", [
    ("nearest", 25.0), ("nearest", 0.0), ("load_balanced", 40.0),
    ("load_balanced", 150.0), ("none", 25.0)])
def test_handover_sequences_match_the_reference(policy, margin):
    sites = topology.cell_sites(4, 550.0)
    cfg = dict(kind="random_waypoint", seed=11, speed_range=(20.0, 60.0),
               hotspot=(150.0, 100.0), hotspot_frac=0.6)
    out = []
    for ns in (jmobility, mobility):
        motion = ns.make_motion(ns.MobilityConfig(**cfg), 16, 550.0)
        eng = ns.HandoverEngine(ns.HandoverConfig(policy, margin), sites)
        cells = ns.assign_nearest(motion.positions_at(0.0), sites)
        seq = [cells.tolist()]
        for t in np.arange(1, 13) * 7.5:
            before = cells.tolist()
            new, moves = eng.reassign(motion.positions_at(float(t)), cells)
            assert cells.tolist() == before     # the input is left as is
            cells = new
            seq.append((cells.tolist(), moves))
        out.append(seq)
    assert out[0] == out[1]
    if policy != "none":
        assert any(moves for _, moves in out[1][1:])


# ----------------------------------------------------------- mobile fleets

@pytest.mark.parametrize("n_cells,kind", [(None, "gauss_markov"),
                                          (3, "random_waypoint"),
                                          (1, "random_waypoint")])
def test_mobile_fleet_envs_and_stream_match_the_reference(n_cells, kind):
    """Sites, the nearest-site initial binding, serving distances and the
    envs at a few times draw as the reference's, and only the fading
    consumes the sampling stream."""
    got = []
    for ns in SIDES.values():
        topo = None if n_cells is None else ns["topology"].TopologyConfig(
            kind="hier", n_cells=n_cells)
        cfg = ns["population"].FleetConfig(
            n_devices=7, topology=topo, mobility=ns["mobility"]
            .MobilityConfig(kind=kind, seed=2, speed_range=(10.0, 30.0)))
        rng = np.random.default_rng(4)
        fl = ns["population"].make_fleet(rng, cfg, np.full(7, 30))
        rec = [fl.sites.tolist(), None if fl.cells is None
               else fl.cells.tolist()]
        for t in (0.0, 4.0, 17.5):
            rec.append(fl.serving_distances(t).tolist())
            rec.append([dataclasses.astuple(e)
                        for e in fl.round_envs(rng, 5.8e5, 3.2e7, t=t)])
            rec.append(dataclasses.astuple(
                fl.device_env(rng, 3, 5.8e5, 3.2e7, t=t)))
        got.append((rec, rng.bit_generator.state))
    assert got[0] == got[1]


def test_config_checks_raise_as_the_reference(tmp_path):
    path = str(tmp_path / "scenario.json")
    mobility.ScenarioTrace(**_scenario()).save(path)    # 2 sites
    for ns in SIDES.values():
        m = ns["mobility"]
        for kw in (dict(kind="teleport"), dict(kind="replay"),
                   dict(kind="gauss_markov", gm_alpha=1.5),
                   dict(hotspot_frac=2.0),
                   dict(kind="random_waypoint", speed_range=(0.0, 3.0))):
            with pytest.raises(ValueError):
                m.MobilityConfig(**kw)
        for kw in (dict(policy="teleport"), dict(margin_m=-1.0)):
            with pytest.raises(ValueError):
                m.HandoverConfig(**kw)
        with pytest.raises(ValueError):
            m.ReplayMobility([[]], 3)
        with pytest.raises(ValueError):
            m.ScenarioTrace(devices=[{"on": [[0, 1]]}], cells=[]) \
                .mobility(2)
        # a scenario with another site count than the topology's cells
        with pytest.raises(ValueError, match="cell sites"):
            ns["population"].make_fleet(
                np.random.default_rng(0), ns["population"].FleetConfig(
                    n_devices=4, topology=ns["topology"].TopologyConfig(
                        kind="hier", n_cells=3),
                    mobility=m.MobilityConfig(kind="replay",
                                              scenario_file=path)),
                np.full(4, 32))
    # the handover the port used to refuse now builds
    topology.TopologyConfig(kind="hier", n_cells=2,
                            handover=mobility.HandoverConfig())


# ---------------------------------------------------------- end-to-end runs

def _hier(policy):
    def build(ns):
        m = ns["mobility"]
        return dict(n_devices=6, topology=ns["topology"].TopologyConfig(
            kind="hier", n_cells=3, handover=m.HandoverConfig(
                policy, margin_m=5.0)), mobility=m.MobilityConfig(
            kind="random_waypoint", seed=9, speed_range=(30.0, 60.0)))
    return build, dict(policy="sync", use_pool=False)


def _replay_scenario(path):
    """6 devices over 2 sites 300 m apart: devices 0 and 3 cross from
    one site's side to the other's within the run, device 1 leaves the
    cell at t = 3 (mid round 0), and cell 0's backhaul steps from 1e8 to
    1e7 bit/s at t = 1, after round 0 ships."""
    scen = dict(
        devices=[
            {"waypoints": [[0, -140, 0], [20, 140, 0]]},
            {"waypoints": [[0, -60, 30]], "on": [[0, 3]]},
            {"waypoints": [[0, 120, -20], [40, 90, 60]]},
            {"waypoints": [[0, 150, 10], [15, -150, 10]]},
            {"waypoints": [[0, -90, -60]], "on": [[0, 100]]},
            {"waypoints": [[0, 60, 80]]},
        ],
        cells=[{"site": [-150, 0], "backhaul_bps": [[0, 1e8], [1, 1e7]]},
               {"site": [150, 0]}])
    with open(path, "w") as f:
        json.dump(scen, f)
    return path


def _replay(path):
    def build(ns):
        return dict(
            n_devices=6, topology=ns["topology"].TopologyConfig(
                kind="hier", n_cells=2, handover=ns["mobility"]
                .HandoverConfig("nearest", margin_m=10.0)),
            mobility=ns["mobility"].MobilityConfig(kind="replay",
                                                   scenario_file=path),
            dynamics=ns["fleet"].FleetDynamicsConfig(
                availability=ns["fleet"].AvailabilityConfig(
                    kind="replay", trace_file=path)))
    return build, dict(policy="sync", use_pool=False)


def _fedbuff_mobile(ns):
    return dict(n_devices=4, mobility=ns["mobility"].MobilityConfig(
        kind="gauss_markov", seed=4, mean_speed=10.0))


CASES = {
    **{f"hier_{p}": _hier(p) for p in ("nearest", "load_balanced", "none")},
    "fedbuff_mobile": (_fedbuff_mobile, dict(
        policy="fedbuff", buffer_size=2, max_wallclock_s=40.0,
        use_pool=False)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}
    path = _replay_scenario(str(tmp_path_factory.mktemp("scen")
                                / "scenario.json"))
    cases = dict(CASES, replay_scenario=_replay(path))

    def get(case):
        if case not in cache:
            cache[case] = run_pair(*cases[case])
        return cache[case]

    return get


@pytest.mark.parametrize("case", list(CASES) + ["replay_scenario"])
def test_mobile_runs_match_the_reference(runs, case):
    assert_runs_match(runs(case))


def test_mobile_runs_exercise_their_branches(runs):
    for policy in ("nearest", "load_balanced"):
        h = runs(f"hier_{policy}")["torch"]
        assert h.total_handovers() > 0
        assert kinds(h)["handover"] == h.total_handovers()
        assert all(r.max_cell_occupancy >= 1 for r in h.rounds)
    none = runs("hier_none")["torch"]
    assert none.total_handovers() == 0 and "handover" not in kinds(none)
    # the replay world: a handover, a churned flight, and cell 0's ships
    # after round 0 at the lower rate
    r = runs("replay_scenario")
    h, sim = r["torch"], r["sim"]
    assert h.total_handovers() > 0 and kinds(h).get("churn", 0) > 0
    assert sum(x.n_aborted for x in h.rounds) > 0
    assert sim.cell_backhaul(0, 0.0).rate_bps == 1e8
    assert all(sim.cell_backhaul(0, x.t_wall).rate_bps == 1e7
               for x in h.rounds)
    assert h.rounds[1].latency_backhaul_s > 10.0    # ~106 Mbit at 1e7
    assert h.rounds[0].latency_backhaul_s < 2.0
    fb = runs("fedbuff_mobile")["torch"]
    assert len(fb.rounds) >= 2 and len(fb.dispatch_log) > 4


# ---------------------------------------------------------------- launcher

def test_launcher_builds_the_reference_configs():
    """The port's flag-to-config functions give the reference's configs
    for one set of flags."""
    import argparse
    import dataclasses as dc

    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain
    args = argparse.Namespace(
        seed=4, availability="replay", availability_seed=None,
        trace_file=None, scenario_trace="w.json", battery="on",
        battery_capacity=25.0, battery_recharge=0.1, selection="oort",
        participation=0.5, selection_seed=9, soc_deadline_scale=0.5,
        soc_deadline_threshold=0.6, mobility="replay", speed=30.0,
        mobility_seed=None, handover_policy="load_balanced",
        handover_margin=40.0, topology="hier", cells=2,
        cell_assignment="round_robin", cell_radius_scale=None,
        cell_deadline=None, backhaul_rate_range=None, backhaul_rate=1e9,
        backhaul_latency=0.01, backhaul_energy=0.0, backhaul_codec="f32",
        backhaul_ef=False)
    for name in ("_dynamics_config", "_mobility_config",
                 "_topology_config"):
        want = dc.asdict(getattr(jtrain, name)(args))
        if "backhaul" in want:     # a field the port's link leaves out
            assert want["backhaul"].pop("payload_factor") is None
        assert dc.asdict(getattr(ttrain, name)(args)) == want, name


def test_cli_runs_dynamics_and_mobility_on_the_cpu(capsys):
    from repro_torch.launch import train as launch_train
    launch_train.main([
        "--device", "cpu", "--devices", "4", "--rounds", "2",
        "--n-train", "128", "--n-test", "32", "--eval-every", "1",
        "--seed", "3", "--topology", "hier", "--cells", "2",
        "--mobility", "random_waypoint", "--speed", "40",
        "--handover-policy", "nearest", "--handover-margin", "5",
        "--availability", "markov", "--battery", "on",
        "--selection", "gain", "--participation", "0.5"])
    out = capsys.readouterr().out
    blob = json.loads(out[out.index("{"):])
    assert (blob["availability"], blob["selection"], blob["mobility"],
            blob["handover_policy"]) == ("markov", "gain",
                                         "random_waypoint", "nearest")
    assert blob["n_handovers"] >= 0 and blob["rows"]["round"] == 1
    assert blob["rows"]["max_cell_occupancy"] >= 1
    assert 0.0 < blob["rows"]["mean_soc"] <= 1.0
