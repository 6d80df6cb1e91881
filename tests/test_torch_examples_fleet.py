"""The port's fleet walkthroughs (``examples/torch_dynamic_fleet.py``,
``torch_hier_cells.py``, ``torch_mobile_fleet.py``,
``torch_telemetry_run.py``) on the CPU, small, each in a subprocess
where ``jax`` and ``repro`` cannot be imported, printing their
counterparts' report lines (the other examples are in
``test_torch_examples.py``)."""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = ("--device", "cpu", "--rounds", "2", "--devices", "4",
         "--n-train", "128")

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


def run_example(name: str, *args: str) -> str:
    # one thread: under pytest-xdist several workers share the cores
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-c", RUN,
                        os.path.join("examples", f"torch_{name}.py"),
                        *args], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stdout[-2000:] + p.stderr[-3000:]
    return p.stdout


def test_dynamic_fleet():
    out = run_example("dynamic_fleet", *SMALL)
    assert "round   static  dynamic  off  aborted    soc" in out
    assert "static : acc=" in out and "dynamic: acc=" in out
    assert "dispatches)" in out


def test_hier_cells():
    out = run_example("hier_cells", *SMALL)
    assert "backhaul_mb" in out
    assert "flat  best_acc=" in out and "hier  best_acc=" in out


def test_mobile_fleet():
    out = run_example("mobile_fleet", *SMALL)
    assert "nearest handover" in out
    assert "peak occupancy" in out
    assert "replayed scenario" in out


def test_telemetry_run():
    out = run_example("telemetry_run", *SMALL)
    assert "trace signatures identical: True" in out
    assert "round records identical:    True" in out
    assert "manifest valid: True (backend=cpu" in out
    assert "(components sum to the round totals" in out
