"""BENCHMARK.json against the benchmark's contract, and the files the
harness finds by name."""
import json
import re

import pytest

import run

MANIFEST = json.loads((run.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "flbench/run.py"]
    assert MANIFEST["paths"] == ["flbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51
    n = len(MANIFEST["workloads"])
    # the check's budget with the full 24 cells
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 \
        + 1200 <= 43200
    assert 1 <= n <= 24


def test_names_units_and_lines():
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for e in MANIFEST["configs"] + MANIFEST["workloads"]:
        assert NAME.match(e["name"])
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for m in MANIFEST["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in MANIFEST["end_to_end"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_finds_its_files(cell):
    manifest, entry, config, traffic, settings = run.load_cell(cell)
    assert entry["chips"] == 1
    assert settings["config"] == entry["config"]
    assert settings["traffic"] == entry["traffic"]
    assert settings["check"]["limits"], "a cell without limits"
    for name in run.metric_names(manifest, entry, False) \
            + run.metric_names(manifest, entry, True):
        assert (run.HERE / "metrics" / f"{name}.py").is_file()
    assert "setup_s" in run.metric_names(manifest, entry, False)
    assert len(run.metric_names(manifest, entry, False)) >= 2
    assert run.metric_names(manifest, entry, True)


#: the parameters' dtype each program runs its configurations in
DTYPES = {"fl_round": ("float32",), "pod_step": ("bfloat16", "float32")}


@pytest.mark.parametrize("cfg", MANIFEST["configs"])
def test_config_files(cfg):
    assert cfg["file"].startswith("flbench/configs/")
    data = json.loads((run.ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"]
    assert (run.HERE / "programs" / f"{data['program']}.py").is_file()
    assert data["model"]["dtype"] in DTYPES[data["program"]]
    assert set(cfg["reduced"]) <= set(data)
    if data["program"] == "pod_step":
        fam = run.HERE / "reference" / f"lm_{data['model']['family']}.py"
        assert fam.is_file()
        assert (run.HERE / "roofline"
                / f"lm_{data['model']['family']}.py").is_file()


def test_pair_of_config_and_traffic_appears_once():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_unknown_cell_is_refused():
    with pytest.raises(run.RunError):
        run.load_cell("no-such-cell")


def test_without_a_card_the_run_prints_nothing(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    rc = run.main(["--workload", MANIFEST["workloads"][0]["name"],
                   "--seed", str(2 ** 31 + 9), "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("loaded,found", [
    (["repro_torch", "repro_torch.core"], []),
    (["repro", "repro.core"], ["repro"]),
    (["jax", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jax_free_module"], []),
])
def test_forbidden_modules_by_whole_top_level_name(monkeypatch, loaded,
                                                   found):
    import sys
    fake = {k: v for k, v in sys.modules.items()
            if k.split(".")[0] not in run.FORBIDDEN}
    fake.update({name: object() for name in loaded})
    monkeypatch.setattr(sys, "modules", fake)
    assert run.loaded_forbidden() == found
