"""The port's optimizers, checkpoints and data functions against the JAX
package's.

Optimizers: the same numpy parameters and gradients, five steps, float32
and bfloat16 leaves.  ``sgd``, ``momentum`` and ``adamw`` (plain, and
with warmup and weight decay) hold the reference's ``update`` run op by
op bit for bit: parameters, moments and ``step``.  The reference's
jitted update differs in the last bits where XLA's CPU backend
contracts a multiply and an add into one fused multiply-add (the port
rounds each, as the reference's source is written): there float32
parameters are held at atol ``JIT_ATOL`` of their scale, and bfloat16
ones bit for bit (measured: equal).  Checkpoints: the reference's file
format both ways, bfloat16 leaves bit for bit.  Data: the same
generator gives the same arrays and batches in both packages.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.data import pipeline, synthetic  # noqa: E402
from repro_torch.train import checkpoint, optimizer  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

JIT_ATOL = 1e-6
SHAPES = {"a": (7, 5), "b": {"c": (33,), "d": (4, 3, 2)}}
OPTS = [("sgd", {}), ("momentum", {}), ("adamw", {}),
        ("adamw", dict(warmup=3, weight_decay=0.1))]


def _tree(rng, dtype, shapes=SHAPES):
    if isinstance(shapes, dict):
        return {k: _tree(rng, dtype, v) for k, v in shapes.items()}
    a = rng.standard_normal(shapes).astype(np.float32)
    return a.astype(jnp.bfloat16) if dtype == "bfloat16" else a


def _numpy(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _bits(a):
    """The bytes of an array, a 0-d one too."""
    return np.atleast_1d(np.asarray(a)).view(np.uint8)


def _run_both(name, kw, dtype, jit):
    """Five updates of each package from one start; the final
    (port params, port state, reference params, reference state)."""
    rng = np.random.default_rng(0)
    p0 = _tree(rng, dtype)
    grads = [_tree(rng, dtype) for _ in range(5)]
    jo = jopt.get_optimizer(name, 0.1, **kw)
    to = optimizer.get_optimizer(name, 0.1, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jo.init(jp)
    tp = bridge.params_from_numpy(p0, "cpu")
    ts = to.init(tp)
    update = jax.jit(jo.update) if jit else jo.update
    for g in grads:
        jp, js = update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = to.update(tp, bridge.params_from_numpy(g, "cpu"), ts)
    return tp, ts, jp, js


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", OPTS)
def test_update_matches_the_reference_op_by_op_bit_for_bit(name, kw, dtype):
    tp, ts, jp, js = _run_both(name, kw, dtype, jit=False)
    for got, want in zip(tree_leaves(bridge.params_to_numpy(tp)),
                         _numpy(jp)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(_bits(got), _bits(want))
    assert int(ts["step"]) == int(js["step"]) == 5
    assert ts["step"].dtype == torch.int32
    for k in ("m", "v"):
        if k in js:
            for got, want in zip(tree_leaves(ts[k]), _numpy(js[k])):
                assert got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,kw", OPTS)
def test_update_matches_the_jitted_reference(name, kw, dtype):
    tp, _, jp, _ = _run_both(name, kw, dtype, jit=True)
    for got, want in zip(tree_leaves(bridge.params_to_numpy(tp)),
                         _numpy(jp)):
        got, want = got.astype(np.float32), want.astype(np.float32)
        atol = JIT_ATOL * np.abs(want).max() if dtype == "float32" else 0
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_update_writes_in_place_and_returns_its_arguments():
    opt = optimizer.adamw(1e-2, warmup=2)
    params = {"w": torch.ones(3, 2, dtype=torch.bfloat16),
              "b": torch.zeros(2)}
    state = opt.init(params)
    before = {k: v.data_ptr() for k, v in params.items()}
    moments = [t.data_ptr() for t in tree_leaves(state["m"])]
    out, out_state = opt.update(params, {"w": torch.ones(3, 2),
                                         "b": torch.ones(2)}, state)
    assert out is params and out_state is state
    assert {k: v.data_ptr() for k, v in params.items()} == before
    assert [t.data_ptr() for t in tree_leaves(state["m"])] == moments
    assert not torch.equal(params["b"], torch.zeros(2))
    assert params["w"].dtype == torch.bfloat16


# ------------------------------------- the reference's tests, on the port

@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adamw"])
def test_optimizers_minimize_quadratic(opt_name):
    opt = optimizer.get_optimizer(opt_name, 0.1)
    target = {"w": torch.tensor([1.0, -2.0, 3.0])}
    params = {"w": torch.zeros(3)}
    state = opt.init(params)

    def loss(p):
        return ((p["w"] - target["w"]) ** 2).sum()

    for _ in range(200):
        g = {"w": 2 * (params["w"] - target["w"])}
        params, state = opt.update(params, g, state)
    assert float(loss(params)) < 1e-2


def test_adamw_moments_dtype_and_shape():
    opt = optimizer.adamw(1e-3)
    params = {"w": torch.zeros((4, 4), dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state["m"]["w"].dtype == torch.float32
    assert tuple(state["m"]["w"].shape) == (4, 4)
    g = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    p2, s2 = opt.update(params, g, state)
    assert p2["w"].dtype == torch.bfloat16
    assert int(s2["step"]) == 1


def test_get_optimizer_rejects_an_unknown_name():
    with pytest.raises(ValueError):
        optimizer.get_optimizer("lion", 0.1)


def test_checkpoint_roundtrip(tmp_path):
    tree = {
        "a": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.ones((4,), dtype=torch.bfloat16)},
        "step_count": torch.tensor(7, dtype=torch.int32),
    }
    checkpoint.save_checkpoint(str(tmp_path), tree, step=42,
                               extra={"note": "x"})
    loaded, step, extra = checkpoint.load_checkpoint(str(tmp_path))
    assert step == 42 and extra["note"] == "x"
    for a, b in zip(tree_leaves(tree), tree_leaves(loaded)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _mixed_tree(rng):
    bf = rng.standard_normal((3, 5)).astype(jnp.bfloat16)
    return {"blocks": {"w": bf, "scale": rng.standard_normal(5).astype(
                np.float32)},
            "step": np.asarray(3, np.int32),
            "ids": np.arange(4, dtype=np.int32)}


def test_checkpoint_saved_by_the_port_loads_in_the_reference(tmp_path):
    npt = _mixed_tree(np.random.default_rng(2))
    checkpoint.save_checkpoint(str(tmp_path),
                               bridge.params_from_numpy(npt, "cpu"),
                               step=5, extra={"arch": "x"})
    loaded, step, extra = jckpt.load_checkpoint(str(tmp_path))
    assert step == 5 and extra == {"arch": "x"}
    for got, want in zip(_numpy(loaded), jax.tree.leaves(npt)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_checkpoint_saved_by_the_reference_loads_in_the_port(tmp_path):
    npt = _mixed_tree(np.random.default_rng(3))
    jckpt.save_checkpoint(str(tmp_path), jax.tree.map(jnp.asarray, npt),
                          step=9)
    loaded, step, extra = checkpoint.load_checkpoint(str(tmp_path))
    assert step == 9 and extra == {}
    for got, want in zip(tree_leaves(bridge.params_to_numpy(loaded)),
                         jax.tree.leaves(npt)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # the two packages write the same manifest for one tree
    other = tmp_path / "port"
    checkpoint.save_checkpoint(str(other), loaded, step=9)
    with open(tmp_path / "manifest.json") as f, \
            open(other / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    assert sorted(np.load(tmp_path / "arrays.npz").files) == sorted(
        np.load(other / "arrays.npz").files)


# --------------------------------------------------------------------- data

def test_batch_iterator_and_epoch_batches_match_the_reference():
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    it, jit_ = pipeline.BatchIterator(a, 10, 4), jpipe.BatchIterator(b, 10,
                                                                      4)
    for _ in range(7):
        np.testing.assert_array_equal(it.next_indices(),
                                      jit_.next_indices())
    got = list(pipeline.epoch_batches(a, 100, 32))
    want = list(jpipe.epoch_batches(b, 100, 32))
    assert len(got) == len(want) == 3
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_batch_iterator_reshuffles():
    it = pipeline.BatchIterator(np.random.default_rng(0), 10, 4)
    seen = [tuple(it.next_indices()) for _ in range(6)]
    flat = [i for b in seen for i in b]
    assert max(flat) < 10 and min(flat) >= 0


def test_epoch_batches_disjoint():
    batches = list(pipeline.epoch_batches(np.random.default_rng(0), 100,
                                          32))
    assert len(batches) == 3
    assert len(np.unique(np.concatenate(batches))) == 96


@pytest.mark.parametrize("seed,n_docs,seq_len,vocab", [(0, 8, 128, 64),
                                                       (5, 16, 64, 512)])
def test_token_dataset_matches_the_reference(seed, n_docs, seq_len, vocab):
    got = synthetic.make_token_dataset(np.random.default_rng(seed), n_docs,
                                       seq_len, vocab)
    want = jsyn.make_token_dataset(np.random.default_rng(seed), n_docs,
                                   seq_len, vocab)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_token_dataset_topic_structure():
    from collections import Counter
    docs = synthetic.make_token_dataset(np.random.default_rng(0), 8, 128,
                                        vocab=64)
    assert docs.shape == (8, 128)
    assert docs.max() < 64 and docs.min() >= 0
    big = Counter(zip(docs[:, :-1].ravel(), docs[:, 1:].ravel()))
    assert big.most_common(1)[0][1] > 3


@pytest.mark.parametrize("shape", [(28, 28, 1), (32, 32, 3)])
def test_image_dataset_matches_the_reference(shape):
    got = synthetic.make_image_dataset(np.random.default_rng(6), 40,
                                       shape=shape)
    want = jsyn.make_image_dataset(np.random.default_rng(6), 40,
                                   shape=shape)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.y, want.y)
    assert got.x.dtype == np.float32 and got.y.dtype == np.int32


def test_checkpoint_writes_the_reference_file_names(tmp_path):
    checkpoint.save_checkpoint(str(tmp_path), {"a": {"b": torch.zeros(2)}})
    assert sorted(os.listdir(tmp_path)) == ["arrays.npz", "manifest.json"]
    assert np.load(tmp_path / "arrays.npz").files == ["a__b"]
