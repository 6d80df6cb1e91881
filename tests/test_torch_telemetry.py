"""The port's telemetry modules against the reference's.

The same calls go to ``repro.telemetry`` and ``repro_torch.telemetry``:
the metrics registry (exact, and folded by a ``RollupPolicy`` with a
histogram cap), the trace sink (with and without a ``TraceSampler``),
the quantile sketch and top-K tracker, the reference checker's verdicts
and the health engine over a synthetic registry.  ``metrics.jsonl``,
``trace.jsonl``, the Perfetto JSON, the alert records and the verdicts
must be identical.  The port's manifest must pass its own
``validate_manifest`` and hash a trace signature as the reference does.
A tiny CPU run of the launcher with ``--telemetry-dir --health`` must
print its tables and write the bundle, give ``History.phase_totals()``
back bit for bit through the port's ``query summary --json``, and the
reference's ``query`` must read the port's bundle as the port's does.
A profile asked for without a directory is refused, and
``profile_trace`` writes a Chrome trace of the ops it ran.
"""
import contextlib
import dataclasses
import io
import json
import os

import pytest

torch = pytest.importorskip("torch")

from repro import telemetry as jtel  # noqa: E402
from repro.telemetry import query as jquery  # noqa: E402
from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.telemetry import query as tquery  # noqa: E402

SIDES = {"jax": jtel, "torch": ttel}


def emit_metrics(reg):
    """A mixed emission sequence over device, cell, phase and round
    labels: counters, gauges (ints, floats, None-free) and histograms."""
    for r in range(3):
        for d in range(10):
            cell = d % 3
            reg.counter("cost.energy_j", 0.1 * (d + 1) + r, device=d,
                        cell=cell, phase="train", round=r)
            reg.counter("cost.comm_bits", 1e5 * (d + 2), device=d,
                        cell=cell, phase="uplink", round=r)
            reg.observe("dispatch.latency_s", 1.0 + 0.37 * d + 0.01 * r,
                        device=d, cell=cell, round=r)
            reg.gauge("learning.update_norm", 0.5 / (d + 1) + r, device=d,
                      round=r)
        reg.gauge("round.latency_s", 10.0 + r, round=r)
        reg.gauge("round.n_clients", 10, round=r)
        reg.counter("fleet.selected", 10.0, round=r)


def registries(rollup: bool):
    out = {}
    for side, mod in SIDES.items():
        pol = mod.RollupPolicy(device_threshold=8, seed=3) if rollup \
            else None
        reg = mod.MetricsRegistry(rollup=pol,
                                  histogram_cap=12 if rollup else 10 ** 6)
        reg.set_fleet_size(10)
        emit_metrics(reg)
        out[side] = reg
    return out


@pytest.mark.parametrize("rollup", [False, True])
def test_registry_records_and_jsonl_match(rollup, tmp_path):
    regs = registries(rollup)
    assert regs["torch"].rollup_active == rollup
    assert list(regs["torch"].records()) == list(regs["jax"].records())
    paths = {}
    for side, reg in regs.items():
        paths[side] = tmp_path / f"{side}.jsonl"
        reg.to_jsonl(str(paths[side]))
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    for name in ("dispatch.latency_s", "learning.update_norm"):
        assert regs["torch"].summary(name) == regs["jax"].summary(name)
        assert regs["torch"].top_devices(name, k=3) == \
            regs["jax"].top_devices(name, k=3)
    # the JSONL round trip rebuilds the same records on both sides
    recs = [json.loads(x) for x in paths["torch"].read_text().splitlines()]
    assert list(ttel.MetricsRegistry.from_records(recs).records()) == \
        list(jtel.MetricsRegistry.from_records(recs).records())


def emit_trace(sink):
    for r in range(3):
        t = 10.0 * r
        for d in range(12):
            sink.span(f"device/{d}", "train", t, t + 1.5 + 0.1 * d,
                      round=r, cell=d % 4, alpha=0.55, energy_j=0.25 * d)
            sink.span(f"device/{d}", "uplink", t + 1.5 + 0.1 * d,
                      t + 2.0 + 0.1 * d, round=r, bits=1e5 * d)
        sink.span("cell/1", "backhaul_ship", t + 3.0, t + 3.5, round=r,
                  codec="int8")
        sink.instant("device/5", "CHURN", t + 0.7, round=r, cell=1)
        sink.instant("server", "EDGE_MERGE", t + 3.5, cell=1, round=r)
        sink.span("server", "round", t, t + 4.0, round=r, n_clients=12)


@pytest.mark.parametrize("sample", [None, 0.5])
def test_trace_sink_outputs_match(sample, tmp_path):
    out = {}
    for side, mod in SIDES.items():
        sampler = mod.TraceSampler(sample, seed=1) if sample else None
        sink = mod.TraceSink(sampler=sampler)
        emit_trace(sink)
        sink.write_jsonl(str(tmp_path / f"{side}.jsonl"))
        sink.write_perfetto(str(tmp_path / f"{side}.json"))
        out[side] = sink
    assert out["torch"].tracks() == out["jax"].tracks()
    for ext in ("jsonl", "json"):
        assert (tmp_path / f"torch.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    if sample:
        kept = [t for t in out["torch"].tracks() if t.startswith("device/")]
        assert 0 < len(kept) < 12
        assert all(ttel.sampled(1, int(t.split("/")[1]), sample)
                   for t in kept)


def test_sketches_and_sampling_match():
    stream = [((i * 7919) % 1013) / 13.0 for i in range(2000)]
    got = {}
    for side, mod in SIDES.items():
        qs, other, top = mod.QuantileSketch(capacity=64, salt="s"), \
            mod.QuantileSketch(capacity=64, salt="s"), mod.TopK(k=5)
        for i, v in enumerate(stream):
            (qs if i % 3 else other).add(v)
            top.add(f"device/{i % 40}", v)
        qs.merge(other)
        got[side] = (qs.to_dict(), [qs.quantile(q) for q in
                                    (0.0, 0.1, 0.5, 0.95, 1.0)],
                     qs.rank_error_bound(), top.to_dict(), top.items(),
                     mod.bottom_k(range(500), 17, seed=2),
                     [mod.hash01("salt", str(i)) for i in range(50)],
                     [mod.sampled(4, i, 0.3) for i in range(50)])
    assert got["torch"] == got["jax"]


def test_reference_verdicts_match():
    record = {"a.b": 1.2, "c": 3.0, "d": True, "e": 7.0}
    baseline = {"a.b": 1.0, "c": 4.0, "d": False, "e": 7.5}
    nested = {"a": {"b": 1.2, "0": [4, 5]}, "l": [{"x": 2}]}
    got = {}
    for side, mod in SIDES.items():
        refs = [mod.Reference("a.b", mod.LOWER, rel_tol=0.05),
                mod.Reference("c", mod.HIGHER, abs_tol=0.5),
                mod.Reference("d", mod.EXACT),
                mod.Reference("e", mod.LOWER, baseline=6.0, abs_tol=2.0),
                mod.Reference("missing")]
        got[side] = ([dataclasses.asdict(v) for v in
                      mod.check_record(record, baseline, refs)],
                     [dataclasses.asdict(mod.check_record(record, None,
                                                          refs)[0])],
                     [mod.extract_path(nested, p)
                      for p in ("a.b", "a.0.1", "l.-1.x", "a.z", "l.9")])
    assert got["torch"] == got["jax"]
    assert [v["status"] for v in got["torch"][0]] == \
        [ttel.FAIL, ttel.FAIL, ttel.FAIL, ttel.PASS, ttel.SKIP]


def health_rules(mod):
    return mod.DEFAULT_RULES + (
        mod.HealthRule("spike-fast", "divergence_spike", "critical",
                       dict(window=2, factor=1.2, min_rounds=1)),
        mod.HealthRule("silent-early", "silent_devices",
                       params=dict(threshold=0.1, min_round=1)))


def test_health_engine_over_a_synthetic_registry(tmp_path):
    out = {}
    for side, mod in SIDES.items():
        tel = mod.Telemetry(str(tmp_path / side))
        tel.health = mod.HealthEngine(health_rules(mod))
        for r in range(8):
            tel.gauge("learning.agg_update_norm", 1.0 + (4.0 if r == 6
                                                        else 0.1 * r),
                      round=r)
            tel.gauge("learning.silent_fraction", 0.5 / (r + 1), round=r)
            tel.gauge("learning.ef_residual_energy", 0.01 * 9 ** r,
                      cell=0, round=r)
            tel.gauge("round.mean_staleness", 0.5 * r, round=r)
            tel.gauge("round.latency_backhaul_s", 0.2 * r, round=r)
            tel.gauge("round.latency_s", 1.0, round=r)
            tel.health.evaluate(r, 10.0 * r, tel.registry, tel)
        out[side] = (tel, tel.flush())
    tt, jt = out["torch"][0], out["jax"][0]
    assert len(tt.health.alerts()) >= 5
    assert tt.health.alerts() == jt.health.alerts()
    assert tt.health.summary_table() == jt.health.summary_table()
    assert set(tt.health.alerts()[0]) == set(ttel.ALERT_KEYS)
    for kind in ("alerts_jsonl", "trace_jsonl", "perfetto",
                 "metrics_jsonl"):
        with open(out["torch"][1][kind], "rb") as a, \
                open(out["jax"][1][kind], "rb") as b:
            assert a.read() == b.read(), kind


def test_manifest_validates_and_hashes_as_the_reference():
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig
    sig = ((0.5, 1, "complete", 3), (1.25, 2, "churn", 0))
    man = ttel.build_manifest(FLRunConfig(), FleetConfig(),
                              OrchestratorConfig(), trace_signature=sig,
                              device="cpu", extra={"x": 1})
    assert ttel.validate_manifest(man) == []
    assert man["backend"] == "cpu" and man["torch"] == torch.__version__
    assert man["n_devices"] == torch.cuda.device_count()
    assert "jax" not in man and set(ttel.COMPARABLE_KEYS) <= set(man)
    assert man["trace_signature_hash"] == jtel.trace_signature_hash(sig)
    assert json.loads(json.dumps(ttel.to_jsonable(man))) == \
        ttel.to_jsonable(man)
    assert ttel.manifest_mismatches(man, dict(man)) == []
    assert ttel.manifest_mismatches(man, dict(man, torch="0")) == \
        ["torch: a='" + torch.__version__ + "' b='0'"]


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A tiny CPU run of the port's launcher with ``--telemetry-dir`` and
    ``--health``: the bundle directory, the history and what it
    printed."""
    out = str(tmp_path_factory.mktemp("bundle"))
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        hist = launch_train.main([
            "--mode", "fl", "--device", "cpu", "--devices", "3",
            "--rounds", "2", "--n-train", "192", "--n-test", "64",
            "--eval-every", "1", "--seed", "5", "--telemetry-dir", out,
            "--health"])
    return out, hist, printed.getvalue()


def test_cli_prints_the_tables_and_writes_the_bundle(bundle):
    out, hist, printed = bundle
    assert "[cost attribution]" in printed
    assert "[health] 0 alerts" in printed or "alert(s)" in printed
    paths = dict(line[len("[telemetry] "):].split(": ", 1)
                 for line in printed.splitlines()
                 if line.startswith("[telemetry] "))
    assert set(paths) == {"perfetto", "trace_jsonl", "metrics_jsonl",
                          "alerts_jsonl", "manifest"}
    assert all(os.path.dirname(p) == out and os.path.getsize(p) > 0
               or k == "alerts_jsonl" for k, p in paths.items())
    with open(paths["manifest"]) as f:
        man = json.load(f)
    assert ttel.validate_manifest(man) == [] and man["backend"] == "cpu"
    assert man["extra"]["phase_totals"] == hist.phase_totals()
    with pytest.raises(SystemExit, match="--health needs"):
        launch_train.main(["--device", "cpu", "--health"])


def test_torch_profile_needs_an_out_dir():
    with pytest.raises(ValueError, match="torch_profile needs an out_dir"):
        ttel.Telemetry(torch_profile=True)
    with pytest.raises(SystemExit, match="--torch-profile needs"):
        launch_train.main(["--device", "cpu", "--torch-profile"])


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with ttel.profile_trace(str(tmp_path)) as prof_dir:
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert prof_dir == os.path.join(str(tmp_path), "torch_profile")
    with open(os.path.join(prof_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names


def test_query_summary_is_bitwise_phase_totals(bundle, capsys):
    out, hist, _ = bundle
    assert tquery.main(["summary", "--telemetry-dir", out, "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == hist.phase_totals()
    assert len(hist.rounds) == 2 and hist.registry is not None


@pytest.mark.parametrize("argv", [
    ["summary"], ["summary", "--json"], ["spans", "--top", "5"],
    ["metric", "learning.update_norm", "--over", "round",
     "--labels", "device=1"],
    ["metric", "dispatch.latency_s", "--over", "device"], ["health"]])
def test_reference_query_reads_the_port_bundle(bundle, capsys, argv):
    out = bundle[0]
    args = argv[:1] + ["--telemetry-dir", out] + argv[1:]
    rc_t = tquery.main(args)
    got_t = capsys.readouterr().out
    rc_j = jquery.main(args)
    got_j = capsys.readouterr().out
    assert rc_t == rc_j == 0
    assert got_t == got_j and got_t.strip()
