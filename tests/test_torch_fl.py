"""The port's synchronous FL round end to end, against a live reference run.

The reference's TINY config (``tests/test_orchestrator.py``: 2 rounds,
n_train 128, no planner), 3 devices, fmnist-cnn at full width.  The port
starts from the reference's initial parameters (carried over as numpy)
and replays the reference's JAX key chain as its uniform source, so both
runs see the same data, channels, strategies and quantization uniforms.

Tolerances: strategies, data draws and the numpy stream exact; bits,
costs and losses rtol 1e-5 (float32 sums in another order); the final
parameters within 1e-3 of the round's update norm (a level index can
flip where a float32 sum lands on a grid boundary); accuracy within 0.02.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.orchestrator import runner as jrunner  # noqa: E402
from repro.orchestrator.policies import OrchestratorConfig as JOrch  # noqa: E402
from repro.orchestrator.policies import make_policy  # noqa: E402
from repro.sysmodel.population import FleetConfig as JFleet  # noqa: E402
from repro.train.fl_loop import FLRunConfig as JRunConfig  # noqa: E402
from repro.utils.pytree import flatten_to_vector  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.orchestrator import policies, runner  # noqa: E402
from repro_torch.sysmodel.population import FleetConfig  # noqa: E402
from repro_torch.train.fl_loop import FLRunConfig, run_fl  # noqa: E402

torch.set_num_threads(1)

TINY = dict(rounds=2, n_train=128, n_test=64, eval_every=1, lr=0.1,
            batch_size=32, seed=3, use_planner=False)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


class JaxKeyChain:
    """A uniform source that replays the reference's key chain: rooted at
    ``PRNGKey(seed + 1)``, split ``(key, k1)`` for the planner and
    ``(key, k1, k2)`` per prepared device, uniforms drawn from the last."""

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


def _record_prepares(sim, log):
    orig = sim.prepare

    def prepare(i, env):
        p = orig(i, env)
        if p is not None:
            log.append((i, p.strat.alpha, p.strat.beta, p.strat.freq,
                        p.alpha, np.asarray(p.batches["labels"]).copy()))
        return p

    sim.prepare = prepare


def _reference_run():
    sim = jrunner.Simulation(JRunConfig(**TINY), JFleet(n_devices=3))
    init = jax.tree.map(np.asarray, sim.params)
    prepares, final = [], {}
    _record_prepares(sim, prepares)
    orig = sim.aggregate

    def aggregate(*a, **k):
        final["params"] = orig(*a, **k)
        return final["params"]

    sim.aggregate = aggregate
    orch = JOrch(policy="sync")
    hist = jrunner._run_round_based(sim, make_policy(orch, fleet_T_max=10.0),
                                    orch, False)
    return sim, init, prepares, hist, jax.tree.map(np.asarray,
                                                   final["params"])


@pytest.fixture(scope="module")
def runs():
    jsim, init, jprep, jhist, jfinal = _reference_run()
    sim = runner.Simulation(FLRunConfig(**TINY), FleetConfig(n_devices=3),
                            device="cpu",
                            uniforms=JaxKeyChain(TINY["seed"] + 1))
    sim.params = bridge.params_from_numpy(init, "cpu")
    tprep = []
    _record_prepares(sim, tprep)
    orch = policies.OrchestratorConfig()
    hist = runner._run_round_based(sim, policies.SyncPolicy(orch), orch,
                                   False)
    return dict(jsim=jsim, init=init, jprep=jprep, jhist=jhist,
                jfinal=jfinal, sim=sim, tprep=tprep, hist=hist)


def test_sync_run_draws_and_strategies_match_exactly(runs):
    assert len(runs["tprep"]) == len(runs["jprep"]) > 0
    for t, j in zip(runs["tprep"], runs["jprep"]):
        assert t[:5] == j[:5]
        np.testing.assert_array_equal(t[5], j[5])
    assert runs["sim"].rng.bit_generator.state == \
        runs["jsim"].rng.bit_generator.state


def test_sync_run_round_logs_match(runs):
    jrounds, trounds = runs["jhist"].rounds, runs["hist"].rounds
    assert len(trounds) == len(jrounds) == TINY["rounds"]
    for t, j in zip(trounds, jrounds):
        for f in ("mean_alpha", "mean_gain", "flops", "latency_train_s",
                  "energy_train_j", "n_clients", "n_dropped"):
            assert getattr(t, f) == getattr(j, f), f
        for f in ("latency_s", "energy_j", "comm_bits", "mean_beta",
                  "t_wall", "energy_uplink_j", "latency_uplink_s",
                  "test_loss"):
            np.testing.assert_allclose(getattr(t, f), getattr(j, f),
                                       rtol=1e-5, err_msg=f)
        assert abs(t.test_acc - j.test_acc) <= 0.02
    # the event trace: arrival order exact, arrival times as the bits
    ttrace, jtrace = runs["hist"].trace, runs["jhist"].trace
    assert [e[1:] for e in ttrace] == [e[1:] for e in jtrace]
    np.testing.assert_allclose([e[0] for e in ttrace],
                               [e[0] for e in jtrace], rtol=1e-5)


def test_sync_run_final_params_match(runs):
    want = np.asarray(flatten_to_vector(runs["jfinal"])[0])
    start = np.asarray(flatten_to_vector(runs["init"])[0])
    got = np.asarray(flatten_to_vector(
        bridge.params_to_numpy(runs["hist"].final_params))[0])
    assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want - start)


def test_port_imports_neither_jax_nor_the_reference():
    """In a fresh interpreter where ``jax`` and ``repro`` cannot be
    imported, every module of the port imports (the baselines, gains,
    codec and energy modules among them) and a flat AnycostFL round, a
    flat QSGD round, a hierarchical CPU round, a pooled fedbuff merge, a
    dynamic round, a mobile hierarchical round, a round with a
    telemetry session attached, the prefill and one decode step of a
    reduced qwen2-7b, falcon-mamba-7b, recurrentgemma-9b and
    seamless-m4t-large-v2, one pod-trainer step of a reduced qwen2-7b
    (the optimizer, the checkpoint and the token data with it), and one
    sharded step of it on a one-rank host mesh (the sharding, mesh and
    step modules), the roofline's cost model and the dry-run's plan
    run, and ``scripts/validate_telemetry_torch.py`` imports."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch
        for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
            importlib.import_module(m.name)
        from repro_torch.core import codec, gains
        from repro_torch.sysmodel import energy
        from repro_torch.train import baselines
        import torch
        torch.set_num_threads(1)
        from repro_torch.sysmodel.population import FleetConfig
        from repro_torch.train.fl_loop import FLRunConfig, run_fl
        hist = run_fl(FLRunConfig(rounds=1, n_train=64, n_test=32,
                                  eval_every=1, seed=1, use_planner=False),
                      FleetConfig(n_devices=2), device="cpu")
        assert hist.rounds[0].test_loss == hist.rounds[0].test_loss
        hist = run_fl(FLRunConfig(method="qsgd", rounds=1, n_train=64,
                                  n_test=32, eval_every=1, seed=1),
                      FleetConfig(n_devices=2), device="cpu")
        assert hist.rounds[0].comm_bits > 0
        from repro_torch.topology import TopologyConfig
        hist = run_fl(FLRunConfig(rounds=1, n_train=64, n_test=32,
                                  eval_every=1, seed=1, use_planner=False),
                      FleetConfig(n_devices=2, topology=TopologyConfig(
                          kind="hier", n_cells=2)), device="cpu")
        assert hist.rounds[0].n_cells_reporting > 0
        assert hist.rounds[0].test_loss == hist.rounds[0].test_loss
        from repro_torch.orchestrator.policies import OrchestratorConfig
        from repro_torch.orchestrator.runner import run_orchestrated
        hist = run_orchestrated(
            FLRunConfig(rounds=1, n_train=64, n_test=32, eval_every=1,
                        seed=1, use_planner=False),
            FleetConfig(n_devices=2),
            OrchestratorConfig(policy="fedbuff", buffer_size=2),
            device="cpu")
        assert hist.rounds[0].n_clients == 2 and hist.peak_inflight == 2
        from repro_torch.fleet import (AvailabilityConfig, BatteryConfig,
                                       FleetDynamicsConfig)
        from repro_torch.mobility import HandoverConfig, MobilityConfig
        hist = run_fl(FLRunConfig(rounds=1, n_train=64, n_test=32,
                                  eval_every=1, seed=1, use_planner=False),
                      FleetConfig(n_devices=4, dynamics=FleetDynamicsConfig(
                          availability=AvailabilityConfig(kind="markov"),
                          battery=BatteryConfig(), selection="gain",
                          participation=0.5)), device="cpu")
        assert hist.rounds[0].n_clients + hist.rounds[0].n_aborted \
            + hist.rounds[0].n_unavailable > 0
        hist = run_fl(FLRunConfig(rounds=1, n_train=64, n_test=32,
                                  eval_every=1, seed=1, use_planner=False),
                      FleetConfig(n_devices=4, topology=TopologyConfig(
                          kind="hier", n_cells=2,
                          handover=HandoverConfig()),
                          mobility=MobilityConfig(kind="random_waypoint")),
                      device="cpu")
        assert hist.rounds[0].n_cells_reporting > 0
        assert hist.rounds[0].max_cell_occupancy > 0
        from repro_torch import telemetry
        for name in ("health", "learning", "manifest", "profiler", "query",
                     "references", "registry", "sampling", "session",
                     "sketch", "trace"):
            importlib.import_module("repro_torch.telemetry." + name)
        tel = telemetry.Telemetry()
        tel.health = telemetry.HealthEngine(telemetry.DEFAULT_RULES)
        hist = run_fl(FLRunConfig(rounds=1, n_train=64, n_test=32,
                                  eval_every=1, seed=1, use_planner=False),
                      FleetConfig(n_devices=2), device="cpu", telemetry=tel)
        assert tel.registry.value("learning.update_norm", device=0,
                                  round=0) > 0
        assert hist.registry is tel.registry and len(tel.sink) > 0
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import prefill_into_cache
        from repro_torch.models.registry import build_model
        for arch in ("qwen2-7b", "falcon-mamba-7b", "recurrentgemma-9b",
                     "seamless-m4t-large-v2"):
            model = build_model(get_config(arch).reduced())
            params = model.init(torch.Generator().manual_seed(0), "cpu")
            toks = torch.arange(4, dtype=torch.int32)[None]
            logits, cache = prefill_into_cache(model, params, toks, 6)
            logits, cache = model.decode(params, cache,
                                         {"tokens": toks[:, :1]})
            assert cache["pos"] == 5 and logits.shape == (1, 1, 512)
            assert bool(torch.isfinite(logits).all())
        import numpy as np, tempfile
        from repro_torch.data import pipeline
        from repro_torch.data.synthetic import make_token_dataset
        from repro_torch.launch.steps import make_train_step
        from repro_torch.train import checkpoint, optimizer
        model = build_model(get_config("qwen2-7b").reduced())
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        opt = optimizer.adamw(3e-3, warmup=10)
        state = opt.init(params)
        docs = make_token_dataset(np.random.default_rng(0), 4, 16, 512)
        idx = pipeline.BatchIterator(np.random.default_rng(1), 4,
                                     2).next_indices()
        params, state, loss = make_train_step(model, opt)(
            params, state, {"tokens": torch.tensor(docs[idx])})
        assert bool(torch.isfinite(loss)) and int(state["step"]) == 1
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save_checkpoint(d, params, step=1)
            back, step, _ = checkpoint.load_checkpoint(d)
        assert step == 1 and torch.equal(back["embed"]["table"],
                                         params["embed"]["table"])
        import torch.distributed as dist
        from repro_torch import sharding
        from repro_torch.configs import get_shape
        from repro_torch.launch import dryrun, mesh, roofline, steps
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        with sharding.use_sharding(mesh.make_host_mesh("cpu")):
            sp = steps.distribute(params, steps.param_shardings(model))
            ss = steps.distribute(opt.init(sp),
                                  steps.opt_state_shardings(opt, model))
            sp, ss, loss = make_train_step(model, opt)(
                sp, ss, {"tokens": torch.tensor(docs[idx])})
        dist.destroy_process_group()
        assert bool(torch.isfinite(loss)) and sharding.is_dtensor(
            sp["embed"]["table"])
        cfg = get_config("qwen2-7b")
        assert roofline.analytic_cost(cfg, get_shape("train_4k"))[
            "flops_total"] > 0
        assert dryrun.plan_entry("seamless-m4t-large-v2", "long_500k") \
            is None
        import importlib.util, os
        spec = importlib.util.spec_from_file_location(
            "validate_telemetry_torch",
            os.path.join(os.path.dirname(repro_torch.__file__), "..", "..",
                         "scripts", "validate_telemetry_torch.py"))
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        assert callable(script.tiny_run)
        assert not [k for k, v in sys.modules.items() if v is not None
                    and (k.split(".")[0] in ("jax", "jaxlib", "repro"))]
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = FLRunConfig(rounds=1, n_train=64, n_test=32, use_planner=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_fl(cfg, FleetConfig(n_devices=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        runner.Simulation(cfg, FleetConfig(n_devices=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--rounds", "1", "--devices", "2"])


def test_cli_runs_on_the_cpu_and_prints_the_final_json(capsys):
    launch_train.main(["--mode", "fl", "--method", "anycostfl",
                       "--device", "cpu", "--rounds", "1", "--devices", "2",
                       "--n-train", "64", "--n-test", "32",
                       "--eval-every", "1", "--seed", "2"])
    out = capsys.readouterr().out
    blob = json.JSONDecoder().raw_decode(out, out.index("{"))[0]
    assert blob["policy"] == "sync" and blob["method"] == "anycostfl"
    assert 0.0 <= blob["best_acc"] <= 1.0
    assert blob["rows"]["round"] == 0 and blob["rows"]["comm_bits"] > 0
    with pytest.raises(SystemExit):
        launch_train.main(["--device", "cpu", "--async-mode", "async"])


def test_cli_runs_a_baseline_on_non_iid_data(capsys):
    launch_train.main(["--mode", "fl", "--method", "qsgd", "--non-iid",
                       "--device", "cpu", "--rounds", "1", "--devices", "2",
                       "--n-train", "64", "--n-test", "32",
                       "--eval-every", "1", "--seed", "2"])
    out = capsys.readouterr().out
    blob = json.JSONDecoder().raw_decode(out, out.index("{"))[0]
    assert blob["arch"] == "fmnist-cnn" and blob["method"] == "qsgd"
    assert blob["rows"]["n_clients"] == 2
    # QSGD keeps 1/16 of the coordinates: far below the raw 32 bits each
    assert 0 < blob["rows"]["mean_beta"] < 0.1
    with pytest.raises(NotImplementedError, match="Pod path"):
        launch_train.main(["--device", "cpu", "--arch", "qwen2-7b"])


def test_outside_the_slice_raises(capsys):
    # the mesh route is accepted and, on one device, falls back to the
    # streaming edge fold with the reference's warning
    assert policies.OrchestratorConfig(agg_route="mesh").agg_route == "mesh"
    sim = runner.Simulation(FLRunConfig(**TINY), device="cpu")
    assert sim.resolve_agg_route("mesh") == "streaming"
    assert "--agg-route mesh needs >= 2 devices" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        runner.Simulation(dataclasses.replace(
            FLRunConfig(**TINY), arch="qwen2-7b"), device="cpu")
