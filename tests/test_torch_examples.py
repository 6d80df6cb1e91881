"""The port's examples (``examples/torch_*.py``) on the CPU, small: each
runs in a subprocess where ``jax`` and ``repro`` cannot be imported, with
``--device cpu`` and reduced sizes, and prints its counterpart's report
lines.  This file takes the quickstart, the heterogeneous and async
fleets, anycost serving and the multi-pod dry-run; the dynamic,
hierarchical, mobile and telemetry walkthroughs are in
``test_torch_examples_fleet.py``.  The dry-run example is driven here on
a pair the CLI skips (two subprocesses, the results read back); its
production traces run on the card machine only (``chip_smoke.py`` phase
15), being full-size.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.join(os.path.dirname(__file__), "..")

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


def test_quickstart():
    out = run_example("quickstart", "--device", "cpu")
    assert "after 1 round" in out and "uplink" in out
    assert out.count("device ") == 3


def test_heterogeneous_fleet():
    out = run_example("heterogeneous_fleet", "1", "--device", "cpu",
                      "--devices", "3", "--n-train", "128")
    assert "method        best_acc  total_time(s)" in out
    for method in ("anycostfl", "stc", "heterofl"):
        assert any(line.startswith(method) for line in out.splitlines())


def test_async_fleet():
    out = run_example("async_fleet", "20", "--device", "cpu", "--rounds",
                      "2", "--devices", "3", "--n-train", "128")
    assert "policy      best_acc  sim_time(s)  merges" in out
    for policy in ("sync", "semisync", "fedbuff"):
        assert f"--- {policy} ---" in out


def test_anycost_serving():
    out = run_example("anycost_serving", "--device", "cpu", "--rounds",
                      "2", "--n-train", "256")
    assert "width  params%  test-acc (no retraining)" in out
    assert "transformer width-elastic serving (qwen2 reduced):" in out
    assert out.count("logits finite=True") == 3


def test_multipod_dryrun_reads_back_the_results():
    out = run_example("multipod_dryrun", "seamless-m4t-large-v2",
                      "long_500k", "--device", "cpu")
    for mesh in ("single", "multi"):
        assert f"[SKIP] seamless-m4t-large-v2 x long_500k ({mesh})" in out


def test_examples_ask_for_the_card_by_default():
    """Without ``--device cpu`` an example raises on a machine without a
    card instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "examples/torch_quickstart.py"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert "no CUDA device is available" in p.stderr


def test_local_round_is_shrink_train_and_finish_with_the_generators_draws():
    """``AnycostClient.local_round`` (the quickstart's call) equals the
    runner's steps, shrink, ``_local_steps`` and ``finish_round``, with
    the uniforms drawn from the same generator."""
    from repro_torch.configs import get_config
    from repro_torch.core import schedule, shrinking
    from repro_torch.core.anycost import AnycostClient, bucket_alpha
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_size
    cfg = get_config("fmnist-cnn")
    model = build_model(cfg)
    spec = shrinking.cnn_shrink_spec(cfg)
    params = shrinking.sort_channels(
        model.init(torch.Generator().manual_seed(0), "cpu"), spec)
    client = AnycostClient(model, spec, lr=0.1, batch_size=8)
    rng = np.random.default_rng(3)
    batches = {"images": torch.tensor(rng.random((2, 8, 28, 28, 1)),
                                      dtype=torch.float32),
               "labels": torch.tensor(rng.integers(0, 10, (2, 8)),
                                      dtype=torch.int32)}
    strat = schedule.Strategy(0.6, 0.05, 1e9, 0.5, 0.5, 0.6 ** 4 * 0.05,
                              1, 1, 1, 1, True)
    got = client.local_round(params, strat, batches,
                             torch.Generator().manual_seed(7))
    alpha = bucket_alpha(strat.alpha)
    sub = shrinking.shrink(params, alpha, spec)
    rand = torch.rand(tree_size(params),
                      generator=torch.Generator().manual_seed(7))
    want = client.finish_round(params, alpha, client._local_steps(
        sub, batches), strat, 2, rand, sub=sub)
    assert got.alpha == want.alpha == alpha and got.bits == want.bits
    for a, b in zip(tree_leaves(got.values) + tree_leaves(got.mask),
                    tree_leaves(want.values) + tree_leaves(want.mask)):
        assert torch.equal(a, b)
