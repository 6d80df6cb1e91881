"""The port's quickstart against the reference's, on the CPU.

* ``AnycostClient.local_round`` (the quickstart's call) against the
  reference's ``local_round`` on narrow fmnist-cnn widths
  (``d_model=4, d_ff=16``): the reference's parameters carried over with
  ``bridge``, the same batches, and the reference's uniforms
  (``jax.random.uniform(key, (N,))``) handed to the port's draw from its
  generator.
* ``examples/torch_quickstart.py`` against ``examples/quickstart.py``,
  both at their default sizes and in this process: the port's run starts
  from the reference's ``PRNGKey(0)`` weights and replays its key chain
  (``key, k = split(key)`` a feasible device) in place of its own
  ``torch.Generator`` draws, so both print the same lines: each
  device's strategy, the test accuracy and the uplink MB.

Tolerances, as in ``test_torch_modules.py``: alpha, masks and printed
lines exact; update values atol 1e-6, but for at most ``MAX_FLIPS``
elements of an update (a uniform that falls between the two sides'
float32 level fractions rounds to the other level: one of the
quickstart's 1.6M coordinates does); bits rtol 1e-5 (sums taken in
another order); aggregated parameters atol 1e-5 but for the
coordinates of those flips.
"""
import contextlib
import dataclasses
import io
import os
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import anycost as janycost  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import shrinking as jshrink  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.utils import pytree as jtree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import anycost, schedule, shrinking  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.utils import pytree  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
MAX_FLIPS = 1


class KeyChain:
    """Stands in for ``torch.rand``: each call returns the next draw of
    the reference's chain, ``key, k = split(key)`` then
    ``uniform(k, (n,))``, on the device asked for."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)
        self.calls = []

    def __call__(self, n, *, generator=None, device=None):
        assert isinstance(generator, torch.Generator)
        self.calls.append(n)
        self.key, k = jax.random.split(self.key)
        return torch.tensor(np.asarray(jax.random.uniform(k, (n,))),
                            device=device)


def _assert_updates_match(got, want):
    assert got.alpha == want.alpha
    assert (got.n_samples, got.flops) == (want.n_samples, want.flops)
    np.testing.assert_allclose(got.bits, float(want.bits), rtol=1e-5)
    np.testing.assert_allclose(got.beta_realized, want.beta_realized,
                               rtol=1e-5)
    for g, w in zip(pytree.tree_leaves(got.mask),
                    jax.tree_util.tree_leaves(want.mask)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    flips = sum(int((np.abs(g.numpy() - np.asarray(w)) > 1e-6).sum())
                for g, w in zip(pytree.tree_leaves(got.values),
                                jax.tree_util.tree_leaves(want.values)))
    assert flips <= MAX_FLIPS


def test_local_round_matches_the_references_local_round(monkeypatch):
    narrow = dict(d_model=4, d_ff=16)
    jcfg = dataclasses.replace(jax_get_config("fmnist-cnn"), **narrow)
    tcfg = dataclasses.replace(get_config("fmnist-cnn"), **narrow)
    jspec, tspec = jshrink.cnn_shrink_spec(jcfg), shrinking.cnn_shrink_spec(
        tcfg)
    jmodel = jreg.build_model(jcfg)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(4)))
    jclient = janycost.AnycostClient(jmodel, jspec, lr=0.1, batch_size=8)
    tclient = anycost.AnycostClient(registry.build_model(tcfg), tspec,
                                    lr=0.1, batch_size=8)
    rng = np.random.default_rng(5)
    batches = {"images": rng.uniform(size=(2, 8, 28, 28, 1))
               .astype(np.float32),
               "labels": rng.integers(0, 10, (2, 8)).astype(np.int32)}
    strat = jsched.Strategy(alpha=0.6, beta=0.05, freq=1e9, phi=0.5,
                            varphi=0.5, gain=0.005, T_cmp=1.0, T_com=1.0,
                            E_cmp=1.0, E_com=1.0, feasible=True)
    chain = KeyChain(6)
    key = jax.random.split(jax.random.PRNGKey(6))[1]

    jsorted = jshrink.sort_channels(jax.tree.map(jnp.asarray, params),
                                    jspec)
    want = jclient.local_round(
        jsorted, strat, {k: jnp.asarray(v) for k, v in batches.items()},
        key, w_per_sample=1e5)

    tsorted = shrinking.sort_channels(bridge.params_from_numpy(params, "cpu"),
                                      tspec)
    monkeypatch.setattr(torch, "rand", chain)
    got = tclient.local_round(
        tsorted, schedule.Strategy(**dataclasses.asdict(strat)),
        {k: torch.tensor(v) for k, v in batches.items()},
        torch.Generator().manual_seed(7), w_per_sample=1e5)
    assert chain.calls == [jtree.tree_size(params)]
    _assert_updates_match(got, want)


def _run(path: str, argv=()) -> tuple[list, dict]:
    saved = sys.argv
    sys.argv = [path, *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            env = runpy.run_path(os.path.join(ROOT, path),
                                 run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines(), env


def test_quickstart_prints_the_references_lines(monkeypatch):
    want_lines, want = _run("examples/quickstart.py")
    init = jax.tree.map(np.asarray, jreg.build_model(
        jax_get_config("fmnist-cnn")).init(jax.random.PRNGKey(0)))
    build = registry.build_model

    def build_with_the_references_weights(cfg):
        model = build(cfg)
        return model._replace(init=lambda gen, device="cpu":
                              bridge.params_from_numpy(init, device))

    monkeypatch.setattr(registry, "build_model",
                        build_with_the_references_weights)
    chain = KeyChain(1)
    monkeypatch.setattr(torch, "rand", chain)
    got_lines, got = _run("examples/torch_quickstart.py", ["--device", "cpu"])
    assert got_lines == want_lines
    assert any("infeasible" in x for x in got_lines)
    assert len(chain.calls) == len(got["updates"]) == len(want["updates"])
    for g, w in zip(got["updates"], want["updates"]):
        _assert_updates_match(g, w)
    # a flipped level moves its coordinate of the aggregate too
    off = sum(int((np.abs(g.numpy() - np.asarray(w)) > 1e-5).sum())
              for g, w in zip(pytree.tree_leaves(got["params"]),
                              jax.tree_util.tree_leaves(want["params"])))
    assert off <= MAX_FLIPS * len(want["updates"])
