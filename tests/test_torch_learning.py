"""The port's learning diagnostics against the reference's.

Unit parity: ``stage_error_energies``, ``alignment_stats``,
``width_mask_template`` (and ``effective_alpha``),
``CodecErrorFeedback.residual_energy`` and ``gini`` on the same seeded
numpy trees, at the reference's own tolerance (``tests/test_learning.py``:
rtol 1e-5 beside ``1e-6 * max(norm, 1)``).

Three live runs with a telemetry session on both sides, each port run
started from the reference's initial parameters with the reference's
JAX key chain as its uniform source (``tests/test_torch_fl.py``): flat
sync with health rules, a 2-cell hierarchy with the ``int8`` codec and
error feedback, and a dynamic fedbuff run (Markov availability and a
battery, so flights CHURN and gated devices RETRY).  Exact: the metric
names, kinds and label sets, the span and instant names and tracks in
emission order, and the alerts' rule, round and kind.  Values: rtol
1e-5 in round 0 and ``LATER_RTOL`` after (the fleet tests' tolerances:
a level index that flips where a float32 sum lands on a grid boundary
moves the next round by a quantization step).  Beside these, the stage
energies take ``1e-6 * max(norm^2, 1)`` in round 0 (the reference's own
tolerance) and ``ENERGY_LATER_ATOL`` of the device's ``norm^2`` after:
from round 1 on a kernel at the sparsification threshold or a level
index can flip, which moves the quantization error of a whole kernel
(read: 7.6e-4 of ``norm^2``).  The cosines of ``alignment_stats`` take
atol ``COS_ATOL``: the reference's float32 ``vdot`` over the 1.66M
coordinates is itself 3.6e-5 to 3e-4 off the float64 cosine of its own
inputs, where the port's is within 3e-7
(``test_alignment_stats_at_full_width_against_float64``).

Invisibility: each port run with its session gives every ``RoundLog``
field, ``History.trace`` and the final parameters ``torch.equal`` to the
same run without one, and a run without telemetry never imports
``repro_torch.telemetry.learning``.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import fleet as jfleet  # noqa: E402
from repro import telemetry as jtel  # noqa: E402
from repro import topology as jtopology  # noqa: E402
from repro.core import aggregation as jaggregation  # noqa: E402
from repro.core import compression as jcompression  # noqa: E402
from repro.core import shrinking as jshrinking  # noqa: E402
from repro.orchestrator import policies as jpolicies  # noqa: E402
from repro.orchestrator import runner as jrunner  # noqa: E402
from repro.sysmodel import population as jpopulation  # noqa: E402
from repro.topology import edge as jedge  # noqa: E402
from repro.train.fl_loop import FLRunConfig as JRunConfig  # noqa: E402
from repro_torch import bridge, fleet, topology  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.core import aggregation, compression, shrinking  # noqa: E402
from repro_torch.orchestrator import policies, runner  # noqa: E402
from repro_torch.sysmodel import population  # noqa: E402
from repro_torch.topology import edge  # noqa: E402
from repro_torch.train.fl_loop import FLRunConfig  # noqa: E402
from repro_torch.utils.pytree import flat_vector, tree_leaves  # noqa: E402
from test_torch_fl import JaxKeyChain  # noqa: E402

torch.set_num_threads(1)

TINY = dict(rounds=3, n_train=128, n_test=64, eval_every=1, lr=0.1,
            batch_size=32, seed=3, use_planner=False)
LATER_RTOL = 1e-4
ENERGY_LATER_ATOL = 2e-3
COS_ATOL = 1e-3
ENERGIES = ("learning.error_energy", "learning.error_total")
COSINES = ("learning.cosine_alignment", "learning.cell_divergence")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SIDES = {
    "jax": dict(fleet=jfleet, topology=jtopology, population=jpopulation,
                tel=jtel),
    "torch": dict(fleet=fleet, topology=topology, population=population,
                  tel=ttel)}


def close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=msg)


def tol(norm):
    return dict(rtol=1e-5, atol=1e-6 * max(norm, 1.0))


# ------------------------------------------------------------ unit parity

def numpy_trees(seed):
    """u, the width mask w, the transmitted mask m (inside w) and decoded
    values q (zero outside m) over two leaves."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (8, 16), "b": (16,), "c": {"d": (4, 3, 5)}}

    def tree(fn, s=shapes):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v)
                for k, v in s.items()}

    u = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    w = tree(lambda s: (rng.random(s) > 0.3).astype(np.float32))
    keep = tree(lambda s: (rng.random(s) > 0.4).astype(np.float32))
    m = jax.tree.map(np.multiply, w, keep)
    q = jax.tree.map(lambda x, mm: (x + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32)) * mm, u, m)
    return u, w, m, q


def both(tree):
    return (jax.tree.map(jnp.asarray, tree),
            bridge.params_from_numpy(tree, "cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stage_error_energies_match(seed):
    trees = numpy_trees(seed)
    jt = [both(t)[0] for t in trees]
    tt = [both(t)[1] for t in trees]
    want = jcompression.stage_error_energies(*jt)
    got = compression.stage_error_energies(*tt)
    norm = float(want.update_norm_sq)
    assert norm > 0 and float(want.e_sparsify) > 0
    for field in compression.StageErrors._fields:
        close(float(getattr(got, field)), float(getattr(want, field)),
              msg=field, **tol(norm))
    z = compression.stage_error_energies({}, {}, {}, {})
    assert [float(v) for v in z] == [0.0] * 5


@pytest.mark.parametrize("seed", [0, 1])
def test_alignment_stats_match(seed):
    u, _, _, q = numpy_trees(seed)
    zero = jax.tree.map(np.zeros_like, u)
    for a, b in ((u, q), (q, u), (u, u), (zero, u), (u, zero)):
        want = jaggregation.alignment_stats(both(a)[0], both(b)[0])
        got = aggregation.alignment_stats(both(a)[1], both(b)[1])
        for g, w in zip(got, want):
            close(float(g), float(w), rtol=1e-5, atol=1e-6)


def test_alignment_stats_at_full_width_against_float64():
    """At the fmnist-cnn width the port's cosine and relative distance
    are float32 sums within 1e-6 of the float64 values; the reference's
    float32 ``vdot`` is held only to ``COS_ATOL`` of them."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    shapes = [tuple(x.shape) for x in tree_leaves(build_model(
        get_config("fmnist-cnn")).init(torch.Generator().manual_seed(0),
                                      "cpu"))]
    rng = np.random.default_rng(7)
    a = {f"l{i}": (rng.standard_normal(s) * 1e-2).astype(np.float32)
         for i, s in enumerate(shapes)}
    b = {k: (0.7 * v + rng.standard_normal(v.shape).astype(np.float32)
             * 1e-2).astype(np.float32) for k, v in a.items()}
    fa = np.concatenate([v.ravel() for _, v in sorted(a.items())])
    fb = np.concatenate([v.ravel() for _, v in sorted(b.items())])
    fa, fb = fa.astype(np.float64), fb.astype(np.float64)
    assert fa.size == 1663370
    cos64 = fa @ fb / np.linalg.norm(fa) / np.linalg.norm(fb)
    rel64 = np.linalg.norm(fa - fb) / np.linalg.norm(fb)
    got = aggregation.alignment_stats(both(a)[1], both(b)[1])
    want = jaggregation.alignment_stats(both(a)[0], both(b)[0])
    close([float(x) for x in got], [cos64, rel64], rtol=0.0, atol=1e-6)
    close([float(x) for x in want], [cos64, rel64], rtol=0.0,
          atol=COS_ATOL)


@pytest.fixture(scope="module")
def fmnist_params():
    from repro.configs import get_config
    from repro.models.registry import build_model
    cfg = get_config("fmnist-cnn")
    params = jax.tree.map(np.asarray,
                          build_model(cfg).init(jax.random.PRNGKey(0)))
    return jshrinking.cnn_shrink_spec(cfg), params


@pytest.mark.parametrize("alpha", [0.25, 0.55, 1.0])
def test_width_mask_template_matches(fmnist_params, alpha):
    jspec, params = fmnist_params
    from repro_torch.configs import get_config
    spec = shrinking.cnn_shrink_spec(get_config("fmnist-cnn"))
    tparams = bridge.params_from_numpy(params, "cpu")
    want = jshrinking.width_mask_template(params, alpha, jspec)
    got = shrinking.width_mask_template(tparams, alpha, spec)
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and the mask the expand path builds from a real sub-update
    sub = shrinking.shrink(tparams, alpha, spec)
    _, mask = shrinking.expand_update(sub, tparams, alpha, spec)
    for g, m in zip(tree_leaves(got), tree_leaves(mask)):
        assert torch.equal(g, m)
    assert shrinking.effective_alpha(spec, alpha, tparams) == \
        jshrinking.effective_alpha(jspec, alpha, params)


def test_ef_residual_energy_matches():
    rng = np.random.default_rng(4)
    shapes = {"b": (256,), "w": (2048,)}
    jef, tef = jedge.CodecErrorFeedback(), edge.CodecErrorFeedback()
    assert tef.residual_energy(0) == (0.0, 0.0)
    for step in range(2):
        num = {k: (rng.standard_normal(s) * 5.0).astype(np.float32)
               for k, s in shapes.items()}
        den = {k: np.abs(v) * 0.5 for k, v in num.items()}
        jef.encode_ship(0, jaggregation.PartialAgg(
            num=jax.tree.map(jnp.asarray, num),
            den=jax.tree.map(jnp.asarray, den), count=2), "int8")
        tnum, tden = both(num)[1], both(den)[1]
        tef.encode_ship(0, aggregation.PartialAgg(
            num=flat_vector(tnum).clone(), den=flat_vector(tden).clone(),
            template=tnum, count=2), "int8")
        want = jef.residual_energy(0)
        got = tef.residual_energy(0)
        assert all(type(x) is float for x in got)
        assert want[0] > 0 and want[1] > 0
        close(got, want, rtol=1e-5, msg=f"step {step}")


def test_gini_matches():
    from repro.telemetry.learning import gini as jgini
    from repro_torch.telemetry.learning import gini
    rng = np.random.default_rng(0)
    for x in ([], [0.0, 0.0], [1.0], [3.0, 1.0, 0.0, 2.0],
              rng.random(50), rng.exponential(size=200) ** 3):
        assert gini(np.asarray(x)) == jgini(np.asarray(x))


# ------------------------------------------------------------- live runs

def health_rules(mod):
    """Rules that fire on every run whatever the last bits: a silent
    fraction above -1 and a backhaul ratio above -1 every round, and an
    aggregate-norm spike over 0 x the trailing median from round 1."""
    return (mod.HealthRule("spike", "divergence_spike",
                           params=dict(window=2, factor=0.0,
                                       min_rounds=1)),
            mod.HealthRule("silent", "silent_devices", "critical",
                           params=dict(threshold=-1.0, min_round=0)),
            mod.HealthRule("backhaul", "backhaul_saturation",
                           params=dict(threshold=-1.0)))


def markov(ns, seed, on, off):
    return ns["fleet"].AvailabilityConfig(kind="markov", seed=seed,
                                          mean_on_s=on, mean_off_s=off)


CASES = {
    "flat_health": (lambda ns: dict(n_devices=4), dict(policy="sync"),
                    True),
    "hier_int8_ef": (lambda ns: dict(
        n_devices=4, topology=ns["topology"].TopologyConfig(
            kind="hier", n_cells=2, backhaul=ns["topology"].BackhaulConfig(
                codec="int8", error_feedback=True))),
        dict(policy="sync"), False),
    "fedbuff_dynamics": (lambda ns: dict(
        n_devices=6, dynamics=ns["fleet"].FleetDynamicsConfig(
            availability=markov(ns, seed=1, on=12.0, off=6.0),
            battery=ns["fleet"].BatteryConfig(capacity_j=20.0,
                                              recharge_w=0.1, seed=3))),
        dict(policy="fedbuff", buffer_size=2, max_wallclock_s=40.0,
             use_pool=False), False),
}


def run_case(case):
    """The reference and the port with a session each, and the port
    again without one."""
    fleet_kw, orch_kw, health = CASES[case]
    out = {}
    jsim = None
    for side, ns in SIDES.items():
        tel = ns["tel"].Telemetry()
        if health:
            tel.health = ns["tel"].HealthEngine(health_rules(ns["tel"]))
        fc = ns["population"].FleetConfig(**fleet_kw(ns))
        if side == "jax":
            jsim = sim = jrunner.Simulation(JRunConfig(**TINY), fc,
                                            telemetry=tel)
            orch = jpolicies.OrchestratorConfig(**orch_kw)
            pol, mod = jpolicies.make_policy(orch, fleet_T_max=10.0), jrunner
        else:
            init = jax.tree.map(np.asarray, jsim.params)
            sims = []
            for t in (tel, None):
                sims.append(runner.Simulation(
                    FLRunConfig(**TINY), fc, device="cpu", telemetry=t,
                    uniforms=JaxKeyChain(TINY["seed"] + 1)))
                sims[-1].params = bridge.params_from_numpy(init, "cpu")
            sim = sims[0]
            orch = policies.OrchestratorConfig(**orch_kw)
            pol, mod = policies.make_policy(orch, fleet_T_max=10.0), runner
            off = sims[1]
            out["off"] = (mod._run_round_based if pol.round_based
                          else mod._run_fedbuff)(
                off, policies.make_policy(orch, fleet_T_max=10.0), orch,
                False)
        run = mod._run_round_based if pol.round_based else mod._run_fedbuff
        out[side] = (run(sim, pol, orch, False), tel)
    return out


@pytest.fixture(scope="module")
def live():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = run_case(case)
        return cache[case]

    return get


def record_key(rec):
    return rec["name"], rec["kind"], tuple(sorted(rec["labels"].items()))


def rtol_of(labels):
    return 1e-5 if labels.get("round", labels.get("version")) == 0 \
        else LATER_RTOL


def atol_of(rec, reg):
    """The absolute part of a live value's tolerance (module docstring):
    the cosines' and, scaled by the device's update energy, the stage
    energies'."""
    if rec["name"] in COSINES:
        return COS_ATOL
    if rec["name"] not in ENERGIES:
        return 0.0
    lab = rec["labels"]
    norm_sq = reg.value("learning.update_norm", device=lab["device"],
                        round=lab["round"]) ** 2
    return 1e-6 * max(norm_sq, 1.0) if lab["round"] == 0 \
        else ENERGY_LATER_ATOL * norm_sq


@pytest.mark.parametrize("case", list(CASES))
def test_live_metrics_match_the_reference(live, case):
    r = live(case)
    jrecs = list(r["jax"][1].registry.records())
    trecs = list(r["torch"][1].registry.records())
    assert [record_key(x) for x in trecs] == [record_key(x) for x in jrecs]
    names = {x["name"] for x in trecs}
    assert {"learning.update_norm", "learning.error_energy",
            "learning.fairness_gini", "cost.energy_j",
            "dispatch.latency_s"} <= names
    for t, j in zip(trecs, jrecs):
        tv, jv = t["value"], j["value"]
        assert type(tv) is type(jv) or {type(tv), type(jv)} <= \
            {float, np.float64}, (t["name"], type(tv), type(jv))
        if jv is None or isinstance(jv, str):
            assert tv == jv
            continue
        close(tv, jv, rtol_of(t["labels"]),
              atol_of(j, r["jax"][1].registry),
              msg=f"{t['name']} {t['labels']}")


@pytest.mark.parametrize("case", list(CASES))
def test_live_trace_and_alerts_match_the_reference(live, case):
    r = live(case)
    tsink, jsink = r["torch"][1].sink, r["jax"][1].sink
    for kind in ("spans", "instants"):
        t, j = getattr(tsink, kind), getattr(jsink, kind)
        assert [(e.track, e.name) for e in t] == \
            [(e.track, e.name) for e in j]
        for a, b in zip(t, j):
            assert set(a.args or {}) == set(b.args or {})
            rt = rtol_of(b.args or {})
            close([getattr(a, f) for f in ("t0", "t1", "t")
                   if hasattr(a, f)],
                  [getattr(b, f) for f in ("t0", "t1", "t")
                   if hasattr(b, f)], rt, msg=f"{a.track} {a.name}")
    names = {e.name for e in tsink.instants}
    th, jh = r["torch"][1].health, r["jax"][1].health
    if case == "flat_health":
        assert [(a["rule"], a["round"], a["kind"]) for a in th.alerts()] \
            == [(a["rule"], a["round"], a["kind"]) for a in jh.alerts()]
        assert len(th.alerts()) >= 7 and "ALERT" in names
    elif case == "hier_int8_ef":
        assert names == {"EDGE_MERGE"}
        assert {e.name for e in tsink.spans} == {"train", "uplink",
                                                 "backhaul_ship", "round"}
    else:
        assert {"CHURN", "RETRY", "BUFFER_MERGE"} <= names


def test_live_hier_diagnostics(live):
    reg = live("hier_int8_ef")["torch"][1].registry
    hist = live("hier_int8_ef")["torch"][0]
    for r in hist.rounds:
        cells = reg.label_values("learning.cell_divergence", "cell")
        assert len([c for c in cells if reg.value(
            "learning.cell_divergence", cell=c, round=r.round)
            is not None]) == r.n_cells_reporting == 2
        for c in cells:
            e = reg.value("learning.ef_residual_energy", cell=c,
                          round=r.round)
            assert e is not None and e > 0


@pytest.mark.parametrize("case", list(CASES))
def test_telemetry_is_invisible_in_the_port(live, case):
    r = live(case)
    on, off = r["torch"][0], r["off"]
    assert len(on.rounds) == len(off.rounds) > 0
    for a, b in zip(on.rounds, off.rounds):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert on.trace == off.trace and on.dispatch_log == off.dispatch_log
    for a, b in zip(tree_leaves(on.final_params),
                    tree_leaves(off.final_params)):
        assert torch.equal(a, b)
    # the session-less run still backs its rounds with a registry
    assert off.registry is not None and off.registry is not on.registry
    assert list(off.registry.records()) and not any(
        x["name"].startswith(("learning.", "cost."))
        for x in off.registry.records())


def test_a_run_without_telemetry_never_imports_the_diagnostics():
    code = textwrap.dedent("""
        import sys
        import torch
        torch.set_num_threads(1)
        from repro_torch.sysmodel.population import FleetConfig
        from repro_torch.topology import TopologyConfig
        from repro_torch.train.fl_loop import FLRunConfig, run_fl
        run_fl(FLRunConfig(rounds=1, n_train=64, n_test=32, eval_every=1,
                           seed=1, use_planner=False),
               FleetConfig(n_devices=2, topology=TopologyConfig(
                   kind="hier", n_cells=2)), device="cpu")
        assert "repro_torch.telemetry.learning" not in sys.modules
        assert "repro_torch.orchestrator.runner" in sys.modules
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")
