"""The port's telemetry validator (``scripts/validate_telemetry_torch.py``)
on the CPU.  ``--run --device cpu`` drives the tiny hierarchical
``--health`` run and checks its bundle, and ``--dir`` accepts a bundle
the port flushed, each in a subprocess where ``jax`` and ``repro``
cannot be imported, with one thread; ``--dir`` refuses a bundle broken
in each of the ways it checks (in this process)."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SCRIPT = os.path.join("scripts", "validate_telemetry_torch.py")

RUN = """
import runpy, sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'repro'):
            raise ImportError(name + ' is blocked')
sys.meta_path.insert(0, Block())
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name='__main__')
"""


def run_script(*args: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-c", RUN, SCRIPT, *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A bundle the port flushed: the validator's own tiny run, 2 devices
    and 1 round smaller, on the CPU."""
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.orchestrator.runner import run_orchestrated
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.telemetry import (HealthEngine, HealthRule, Telemetry,
                                       build_manifest)
    from repro_torch.topology import TopologyConfig
    from repro_torch.train.fl_loop import FLRunConfig
    torch.set_num_threads(1)
    out = str(tmp_path_factory.mktemp("bundle"))
    run_cfg = FLRunConfig(rounds=1, n_train=64, n_test=32, eval_every=1,
                          seed=1, use_planner=False)
    fleet = FleetConfig(n_devices=4,
                        topology=TopologyConfig(kind="hier", n_cells=2))
    orch = OrchestratorConfig(policy="sync")
    tel = Telemetry(out)
    tel.health = HealthEngine((HealthRule(
        "any-backhaul", "backhaul_saturation", params={"threshold": 0.0}),))
    hist = run_orchestrated(run_cfg, fleet, orch, device="cpu",
                            telemetry=tel)
    tel.flush(manifest=build_manifest(run_cfg, fleet, orch, device="cpu",
                                      trace_signature=hist.trace))
    return out


def test_run_on_the_cpu_validates_its_bundle_and_query_health():
    p = run_script("--run", "--device", "cpu")
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert any(line.startswith("OK bundle ") and " alerts" in line
               for line in lines)
    assert any(line.startswith("OK query health ") and "[health]" in line
               for line in lines)


def test_dir_accepts_a_port_bundle(bundle):
    p = run_script("--dir", bundle)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    assert p.stdout.startswith(f"OK bundle {bundle}: ")
    assert "alerts" in p.stdout


def _break_dur(d):
    path = os.path.join(d, "trace.perfetto.json")
    with open(path) as f:
        doc = json.load(f)
    next(ev for ev in doc["traceEvents"] if ev["ph"] == "X")["dur"] = -1
    with open(path, "w") as f:
        json.dump(doc, f)


def _break_track(d):
    path = os.path.join(d, "trace.perfetto.json")
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] = [ev for ev in doc["traceEvents"] if ev["ph"] != "M"]
    with open(path, "w") as f:
        json.dump(doc, f)


def _break_instant(d):
    path = os.path.join(d, "trace.perfetto.json")
    with open(path) as f:
        doc = json.load(f)
    next(ev for ev in doc["traceEvents"] if ev["ph"] == "i")["s"] = "x"
    with open(path, "w") as f:
        json.dump(doc, f)


def _break_jsonl(d):
    path = os.path.join(d, "trace.jsonl")
    with open(path) as f:
        rows = f.readlines()
    with open(path, "w") as f:
        f.writelines(rows[:-1])


def _break_alerts(d):
    path = os.path.join(d, "alerts.jsonl")
    with open(path) as f:
        rec = json.loads(f.readline())
    rec["extra"] = 1
    with open(path, "w") as f:
        f.write(json.dumps(rec) + "\n")


def _break_manifest(d):
    path = os.path.join(d, "manifest.json")
    with open(path) as f:
        doc = json.load(f)
    del doc["torch"]
    with open(path, "w") as f:
        json.dump(doc, f)


@pytest.mark.parametrize("breaker,message", [
    (_break_dur, "bad dur"), (_break_track, "undeclared track"),
    (_break_instant, "bad instant scope"), (_break_jsonl, "trace.jsonl has"),
    (_break_alerts, "alert keys"), (_break_manifest, "missing keys")],
    ids=["dur", "track", "instant", "jsonl", "alerts", "manifest"])
def test_dir_refuses_a_broken_bundle(bundle, tmp_path, capsys, breaker,
                                    message):
    """In this process (the subprocess runs above show the script needs
    neither ``jax`` nor ``repro``): ``main(["--dir", D])`` exits 1."""
    spec = importlib.util.spec_from_file_location(
        "validate_telemetry_torch", os.path.join(ROOT, SCRIPT))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    d = str(tmp_path / "broken")
    shutil.copytree(bundle, d)
    breaker(d)
    with pytest.raises(SystemExit) as exc:
        script.main(["--dir", d])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert out.startswith("FAIL: ") and message in out


def test_run_asks_for_the_card_by_default():
    """Without ``--device cpu`` the run raises on a machine without a
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = run_script("--run")
    assert p.returncode != 0
    assert "no CUDA device is available" in p.stderr
