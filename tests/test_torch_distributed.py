"""The port's compressed cross-pod gradient sync (``core/distributed.py``),
its meshes (``launch/mesh.py``), the ``"anycost"`` train step and the
many-rank ``mesh`` aggregation route, against the JAX package on the CPU.

One rank is one pod (or one edge cell).  The port runs in a two-rank
``gloo`` group, spawned once for the module (``torch.multiprocessing``,
a ``FileStore`` under ``tmp_path``, so no TCP port is taken); each rank
writes what it computed to a file.  The reference's functions run in this
process under ``jax.vmap(..., axis_name="pod")``, which binds the axis
over a stacked ``(P, ...)`` input on one CPU device, eagerly (under
``jax.jit`` XLA folds the constant ``erfinv(1 - keep_frac)`` with another
evaluator, which can differ in the last bit).

Tolerances: the keep thresholds bit for bit where the sum of squares is
exact in any order (leaves of small multiples of 1/64); elsewhere the
port sums in another order than XLA, so a threshold may move by one ulp
and flip a coordinate that lies on it: the keep masks may differ in at
most ``MAX_FLIPS`` coordinates a case, and the synced values are exact
(``assert_array_equal``) wherever every pod's mask agrees.  The mesh
aggregate within 1e-5 of the stacked Eq. 5 and of the reference's
one-device mesh route (float reordering, the reference's own bound).
The train step's pod-mean loss within 1e-6 and each pod's gradient leaf
within 1e-5 of the leaf's largest |g| (``tests/test_torch_pod.py``'s
bound).  Both ranks' outputs equal bit for bit.
"""
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.scipy.special import erfinv as jerfinv  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.core.aggregation import aio_aggregate_stacked  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import loss_fn as jloss  # noqa: E402
from repro.orchestrator import runner as jrunner  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.orchestrator import policies, runner  # noqa: E402
from repro_torch.sysmodel.population import FleetConfig  # noqa: E402
from repro_torch.topology import TopologyConfig  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.train.fl_loop import FLRunConfig  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

WORLD = 2
MAX_FLIPS = 1
ARCH = "qwen2-7b"
B, S = 4, 16
LR = 0.1
TRAIN_KEEP = 0.25
#: the reference's ``tests/test_distributed.py`` leaves (a leading pod
#: axis) and its zero-collision leaf: pod 0 keeps 0.05, which quantizes
#: to level 0 beside pod 1's 8.0, and the mask still counts it
SCRIPT = {"w": (np.arange(64, dtype=np.float32).reshape(2, 32) + 1.0)
          / 64.0,
          "b": np.asarray([[1.0, -2.0], [3.0, -4.0]], np.float32)}
COLLIDE = {"w": np.asarray([[100.0, 0.05, 50.0, -25.0],
                            [100.0, 8.0, 50.0, -25.0]], np.float32)}
_RNG = np.random.default_rng(0)
RAND = {"b": _RNG.standard_normal((2, 24)).astype(np.float32),
        "w": _RNG.standard_normal((2, 16, 24)).astype(np.float32)}
#: a larger leaf, so that a threshold lands among many magnitudes
WIDE = {"w": _RNG.standard_normal((2, 64, 96)).astype(np.float32)}
INPUTS = {"script": SCRIPT, "collide": COLLIDE, "rand": RAND, "wide": WIDE}
#: name -> (inputs, keyword arguments of anycost_gradient_sync)
SYNC_CASES = {
    "lossless": ("script", dict(keep_frac=1.0, quantize=False)),
    "int8": ("script", dict(keep_frac=1.0, quantize=True)),
    "sparse": ("script", dict(keep_frac=0.25, quantize=False)),
    "collision": ("collide", dict(keep_frac=0.999999, quantize=True)),
    "rand_lossless": ("rand", dict(keep_frac=1.0, quantize=False)),
    "rand_int8": ("rand", dict(keep_frac=1.0, quantize=True)),
    "rand_sparse": ("rand", dict(keep_frac=0.25, quantize=False)),
    "rand_default": ("rand", dict()),
    "wide_default": ("wide", dict()),
    "wide_sparse_int8": ("wide", dict(keep_frac=0.25)),
}
EF_KEEP = 0.25
#: mesh_cell_aggregate: the reference script's I x N, and the mesh route
CELL_I, CELL_N = 8, 640
ROUTE_I = 5                      # odd: the route pads with a zero row
ROUTE_SHAPES = {"a": (3, 7), "b": (7,), "c": (2, 3, 5)}
TINY = dict(rounds=1, n_train=128, n_test=64, eval_every=1, lr=0.1,
            batch_size=32, seed=3, use_planner=False)


def _pod(tree, rank):
    return {k: torch.tensor(v[rank]) for k, v in tree.items()}


def _np(tree):
    return {k: v.detach().numpy().copy() for k, v in tree.items()}


def _cells():
    rng = np.random.default_rng(5)
    u = rng.standard_normal((CELL_I, CELL_N)).astype(np.float32)
    m = (rng.uniform(size=(CELL_I, CELL_N)) > 0.4).astype(np.float32)
    w = rng.uniform(0.5, 1.5, CELL_I).astype(np.float32)
    return u, m, w


def _route_inputs():
    rng = np.random.default_rng(6)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in ROUTE_SHAPES.items()}
    ups = []
    for _ in range(ROUTE_I):
        mask = {k: (rng.uniform(size=s) > 0.3).astype(np.float32)
                for k, s in ROUTE_SHAPES.items()}
        vals = {k: (rng.standard_normal(s) * mask[k]).astype(np.float32)
                for k, s in ROUTE_SHAPES.items()}
        ups.append((vals, mask, float(rng.uniform(0.5, 2.0))))
    return params, ups


def _pairs(ups, to_tensor):
    return [(types.SimpleNamespace(update=types.SimpleNamespace(
        values=to_tensor(v), mask=to_tensor(m))), w) for v, m, w in ups]


def _hier_sim(route):
    """One round of a 4-device, 2-cell hierarchy on ``route``: the
    evaluated parameters (leaves), the test losses, the route taken."""
    sim = runner.Simulation(
        FLRunConfig(**TINY),
        FleetConfig(n_devices=4,
                    topology=TopologyConfig(kind="hier", n_cells=2)),
        device="cpu")
    evals, ev = [], sim.evaluate

    def evaluate(params):
        evals.append([v.numpy().copy() for v in tree_leaves(params)])
        return ev(params)

    sim.evaluate = evaluate
    orch = policies.OrchestratorConfig(agg_route=route)
    sim.agg_route = sim.resolve_agg_route(orch.agg_route)
    hist = runner._run_round_based(sim, policies.SyncPolicy(orch), orch,
                                   False)
    return evals, [r.test_loss for r in hist.rounds], sim.agg_route


def _rank_main(rank, store, out_dir):
    """One pod: every case of the module on this rank, saved to
    ``out_dir/rank{rank}.pt``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    out = {"sync": {}}
    for name, (inp, kw) in SYNC_CASES.items():
        out["sync"][name] = _np(distributed.anycost_gradient_sync(
            _pod(INPUTS[inp], rank), "pod", **kw))
    out["exact"] = _np(distributed.mean_gradient_sync(_pod(RAND, rank)))
    pod_mesh = tmesh.make_pod_mesh(WORLD)
    out["describe"] = (tmesh.describe(pod_mesh),
                       tmesh.describe(tmesh.make_host_mesh()))
    out["via_mesh"] = _np(distributed.anycost_gradient_sync(
        _pod(RAND, rank), "pod", mesh=pod_mesh))
    g = _pod(RAND, rank)
    res = distributed.init_error_feedback(g)
    ef = []
    for _ in range(2):
        synced, res = distributed.anycost_gradient_sync_ef(
            g, res, keep_frac=EF_KEEP)
        ef.append((_np(synced), _np(res)))
    out["ef"] = ef
    u, m, w = (torch.tensor(x) for x in _cells())
    out["cells"] = distributed.mesh_cell_aggregate(u, m, w).numpy()
    out["cells_partial"] = tuple(
        x.numpy() for x in distributed.mesh_cell_aggregate(
            u, m, w, finalize=False))
    params, ups = _route_inputs()
    sim = types.SimpleNamespace(server=types.SimpleNamespace(server_lr=1.0))
    new = runner._mesh_route_params(
        sim, _pairs(ups, lambda t: bridge.params_from_numpy(t, "cpu")),
        bridge.params_from_numpy(params, "cpu"))
    out["route"] = _np(new)
    # stacks that differ across the ranks: one extra row on rank 1, then
    # the same row count with one weight changed on rank 1
    out["diverged"] = []
    for extra in ((u[:1], m[:1], w[:1]), None):
        uu, mm, ww = u, m, w.clone()
        if extra is not None and rank == 1:
            uu, mm, ww = (torch.cat([a, b]) for a, b in zip((u, m, w),
                                                             extra))
        elif extra is None and rank == 1:
            ww[3] += 1.0
        try:
            distributed.mesh_cell_aggregate(uu, mm, ww)
            out["diverged"].append(None)
        except RuntimeError as e:
            out["diverged"].append(str(e))
    # the "anycost" train step, its pod's loss and gradients beside it
    data = np.load(os.path.join(out_dir, "lm.npz"))
    model = build_model(configs.get_config(ARCH).reduced())
    flat = {k[2:]: v for k, v in data.items() if k.startswith("p.")}
    tparams = bridge.params_from_numpy(_unflat(flat), "cpu")
    batch = {"tokens": torch.tensor(data["tokens"])}
    rows = B // WORLD
    loss, grads = steps.value_and_grad(
        model, tparams, {"tokens": batch["tokens"][rank * rows:
                                                   (rank + 1) * rows]},
        remat="full")
    out["local"] = (float(loss), [g.numpy().copy()
                                  for g in tree_leaves(grads)])
    seen = {}
    sgd = optimizer.sgd(LR)

    def update(p, g, s):
        seen["grads"] = [x.numpy().copy() for x in tree_leaves(g)]
        return sgd.update(p, g, s)

    step = steps.make_train_step(
        model, optimizer.Optimizer(sgd.init, update), remat="full",
        grad_sync="anycost", keep_frac=TRAIN_KEEP, mesh=pod_mesh)
    new_params, _, step_loss = step(tparams, sgd.init(tparams), batch)
    out["step"] = (float(step_loss), seen["grads"],
                   [x.numpy().copy() for x in tree_leaves(new_params)])
    out["hier_mesh"] = _hier_sim("mesh")
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _unflat(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' outputs, after one spawn of the two-rank group."""
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("pods")
    jm = jbuild(jconfigs.get_config(ARCH).reduced())
    # the port's initialisation, carried to the reference (JAX's jitted
    # init takes longer than the rest of a test here)
    params = bridge.params_to_numpy(build_model(configs.get_config(
        ARCH).reduced()).init(torch.Generator().manual_seed(0), "cpu"))
    tokens = np.random.default_rng(1).integers(
        0, jm.cfg.vocab_size, (B, S)).astype(np.int32)
    np.savez(d / "lm.npz", tokens=tokens,
             **{f"p.{k}": v for k, v in _flat_paths(params).items()})
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d)),
                       nprocs=WORLD, start_method="spawn")
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return {"outs": outs, "jm": jm, "params": params, "tokens": tokens}


def _vmapped(fn, tree):
    """The reference's ``fn`` over the pod axis of a stacked tree."""
    return jax.tree.map(np.asarray, jax.vmap(fn, axis_name="pod")(
        jax.tree.map(jnp.asarray, tree)))


def _keep(tree, keep_frac):
    """Each pod's keep mask, in the reference and in the port."""
    ref, port = {}, {}
    for k, v in tree.items():
        # vmapped, as inside the sync: the same eager ops on the same shape
        thr = np.asarray(jax.vmap(lambda x: jdist.magnitude_threshold(
            x, keep_frac))(jnp.asarray(v)))
        ref[k] = np.abs(v) >= thr.reshape((-1,) + (1,) * (v.ndim - 1))
        port[k] = np.stack([distributed._local_compress(
            torch.tensor(x), keep_frac, False)[0].numpy() for x in v])
    return ref, port


def _same_where_masks_agree(got, want, tree, keep_frac):
    """Exact where every pod's keep mask agrees; at most MAX_FLIPS keep
    decisions differ over the case.  Returns the flips."""
    ref_keep, port_keep = _keep(tree, keep_frac)
    flips = 0
    for k in want:
        differ = ref_keep[k] != port_keep[k]
        flips += int(differ.sum())
        agree = ~differ.any(axis=0)
        np.testing.assert_array_equal(got[k][agree], want[k][agree],
                                      err_msg=k)
    assert flips <= MAX_FLIPS
    return flips


def test_both_ranks_give_the_same_outputs(ranks):
    a, b = ranks["outs"]
    for name in SYNC_CASES:
        for k in a["sync"][name]:
            np.testing.assert_array_equal(a["sync"][name][k],
                                          b["sync"][name][k])
    for k in a["exact"]:
        np.testing.assert_array_equal(a["exact"][k], b["exact"][k])
    np.testing.assert_array_equal(a["cells"], b["cells"])
    for k in a["route"]:
        np.testing.assert_array_equal(a["route"][k], b["route"][k])
    assert a["step"][0] == b["step"][0]
    for x, y in zip(a["step"][1] + a["step"][2], b["step"][1] + b["step"][2]):
        np.testing.assert_array_equal(x, y)
    assert a["hier_mesh"][1] == b["hier_mesh"][1]
    for x, y in zip(a["hier_mesh"][0], b["hier_mesh"][0]):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("name", list(SYNC_CASES))
def test_anycost_sync_matches_the_reference(ranks, name):
    inp, kw = SYNC_CASES[name]
    tree = INPUTS[inp]
    want = _vmapped(lambda x: jdist.anycost_gradient_sync(x, "pod", **kw),
                    tree)
    for rank, out in enumerate(ranks["outs"]):
        got = out["sync"][name]
        _same_where_masks_agree(
            got, {k: v[rank] for k, v in want.items()}, tree,
            kw.get("keep_frac", 1.0 / 16.0))
    if name == "collision":
        # the kept-but-zero level counts in the denominator: the mean of
        # 0 and ~8, not pod 1's 8 alone (the reference's own check)
        assert ranks["outs"][0]["sync"][name]["w"][1] == pytest.approx(
            4.0, abs=0.5)


def test_mean_sync_and_the_pod_mesh_match_the_reference(ranks):
    exact = _vmapped(lambda x: jdist.mean_gradient_sync(x, "pod"), RAND)
    default = _vmapped(lambda x: jdist.anycost_gradient_sync(x, "pod"), RAND)
    for rank, out in enumerate(ranks["outs"]):
        for k in RAND:
            np.testing.assert_array_equal(out["exact"][k], exact[k][rank])
        _same_where_masks_agree(out["via_mesh"],
                                {k: v[rank] for k, v in default.items()},
                                RAND, 1.0 / 16.0)
        assert out["describe"] == ("pod=2", "data=1 x model=2")


def test_error_feedback_sync_matches_the_reference(ranks):
    def two_steps(x):
        res = jdist.init_error_feedback(x)
        out = []
        for _ in range(2):
            synced, res = jdist.anycost_gradient_sync_ef(
                x, res, "pod", keep_frac=EF_KEEP)
            out.append((synced, res))
        return out

    want = _vmapped(two_steps, RAND)
    for rank, out in enumerate(ranks["outs"]):
        for (got_s, got_r), (want_s, want_r) in zip(out["ef"], want):
            for k in RAND:
                np.testing.assert_array_equal(got_s[k], want_s[k][rank])
                np.testing.assert_array_equal(got_r[k], want_r[k][rank])


def test_erfinv_is_the_references_bit_for_bit():
    rng = np.random.default_rng(2)
    fracs = ([1 / 16, 0.25, 0.5, 0.999999, 1 / 3, 0.1, 0.01, 1e-6]
             + list(rng.uniform(0, 1, 200))
             + list(10 ** rng.uniform(-7, 0, 100)))
    want = np.asarray(jax.vmap(jerfinv)(
        jnp.asarray(np.float32(1.0 - np.asarray(fracs)))))
    got = np.asarray([distributed.erfinv_f32(1.0 - f) for f in fracs],
                     np.float32)
    np.testing.assert_array_equal(got, want)
    # torch's own float32 erfinv is one ulp off at the default keep
    # fraction's argument: the reason for the port's copy
    assert torch.special.erfinv(torch.tensor(1 - 1 / 16)).item() \
        != float(want[0])


@pytest.mark.parametrize("keep_frac", [1 / 16, 0.25, 0.5, 0.999999, 1.0])
@pytest.mark.parametrize("inp", ["script", "grid"])
def test_magnitude_threshold_is_the_references_bit_for_bit(keep_frac, inp):
    """Leaves whose sum of squares is exact in any order: small multiples
    of 1/64, so the threshold is the reference's to the bit."""
    if inp == "script":
        leaves = [v[p] for v in SCRIPT.values() for p in range(2)]
    else:
        rng = np.random.default_rng(3)
        leaves = [(rng.integers(-64, 65, s) / 64.0).astype(np.float32)
                  for s in ((7,), (16, 24), (3, 5, 11))]
    for x in leaves:
        want = np.asarray(jdist.magnitude_threshold(jnp.asarray(x),
                                                    keep_frac))
        got = distributed.magnitude_threshold(torch.tensor(x), keep_frac)
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == float(want)


def test_magnitude_threshold_on_random_leaves_within_the_sum_bound():
    """Gaussian leaves: the sum of squares rounds in another order than
    XLA's.  Any order of n float32 additions is within (n-1) u of the
    exact sum (u = 2^-24), the square root halves that, and the four
    roundings after it add 4 u: the threshold is held at n u."""
    rng = np.random.default_rng(4)
    for _ in range(20):
        x = rng.standard_normal((37, 11)).astype(np.float32)
        want = np.float32(jdist.magnitude_threshold(jnp.asarray(x), 1 / 16))
        got = np.float32(distributed.magnitude_threshold(torch.tensor(x),
                                                         1 / 16).item())
        np.testing.assert_allclose(got, want, rtol=x.size * 2.0**-24)


def test_mesh_cell_aggregate_matches_the_oracle_and_the_reference(ranks):
    u, m, w = _cells()
    flat = np.asarray(aio_aggregate_stacked(jnp.asarray(u), jnp.asarray(m),
                                            jnp.asarray(w)))
    one_device = np.asarray(jdist.mesh_cell_aggregate(
        jnp.asarray(u), jnp.asarray(m), jnp.asarray(w),
        jax.make_mesh((1,), ("cell",))))
    for out in ranks["outs"]:
        np.testing.assert_allclose(out["cells"], flat, atol=1e-5)
        np.testing.assert_allclose(out["cells"], one_device, atol=1e-5)
        num, den = out["cells_partial"]
        fin = np.where(den > 0, num / np.maximum(den, 1e-12), 0.0)
        np.testing.assert_allclose(fin, flat, atol=1e-5)


def test_mesh_route_matches_the_references_and_the_batched_route(ranks):
    params, ups = _route_inputs()
    jsim = types.SimpleNamespace(server=types.SimpleNamespace(server_lr=1.0))
    ref = jrunner._mesh_route_params(
        jsim, _pairs(ups, lambda t: jax.tree.map(jnp.asarray, t)),
        jax.tree.map(jnp.asarray, params))
    from repro_torch.core import aggregation
    tp = bridge.params_from_numpy(params, "cpu")
    batched = aggregation.aio_aggregate(
        [bridge.params_from_numpy(v, "cpu") for v, _, _ in ups],
        [bridge.params_from_numpy(m, "cpu") for _, m, _ in ups],
        torch.tensor([w for _, _, w in ups]))
    for out in ranks["outs"]:
        for k in params:
            np.testing.assert_allclose(out["route"][k], np.asarray(ref[k]),
                                       atol=1e-5)
            np.testing.assert_allclose(
                out["route"][k], (tp[k] - batched[k]).numpy(), atol=1e-5)


def test_mesh_cell_aggregate_raises_on_every_rank_when_stacks_differ(ranks):
    """One rank with an extra row, then one with another weight: both
    ranks raise, and neither folds misaligned blocks."""
    for out in ranks["outs"]:
        assert len(out["diverged"]) == 2
        for msg in out["diverged"]:
            assert msg is not None and "different stacks" in msg
    extra_row = ranks["outs"][0]["diverged"][0]
    assert "[8.0," in extra_row and "[9.0," in extra_row


def test_two_rank_hierarchy_on_the_mesh_route_matches_batched(ranks):
    """The same one-round 2-cell run on the mesh route (both ranks) and on
    the batched route (one process): the same updates, aggregated in
    another order."""
    evals, losses, route = _hier_sim("batched")
    assert route == "batched"
    for out in ranks["outs"]:
        got_evals, got_losses, got_route = out["hier_mesh"]
        assert got_route == "mesh"
        assert len(got_evals) == len(evals) == 1
        for got, want in zip(got_evals[0], evals[0]):
            np.testing.assert_allclose(got, want, atol=1e-5)
        np.testing.assert_allclose(got_losses, losses, rtol=1e-5)


def test_anycost_train_step_matches_the_reference(ranks):
    jm, params, tokens = ranks["jm"], ranks["params"], ranks["tokens"]
    per_pod = tokens.reshape(WORLD, B // WORLD, S)

    @jax.jit
    def pods(p, toks):
        return jax.vmap(jax.value_and_grad(
            lambda q, t: jloss(jm, q, {"tokens": t}, remat="full")),
            in_axes=(None, 0))(p, toks)

    jl, jg = pods(jax.tree.map(jnp.asarray, params), jnp.asarray(per_pod))
    jg = [np.asarray(x) for x in jax.tree.leaves(jg)]
    outs = ranks["outs"]
    # each pod's loss and gradients, then the pod mean of the loss
    for rank, out in enumerate(outs):
        loss, grads = out["local"]
        assert abs(loss - float(jl[rank])) <= 1e-6
        for g, want in zip(grads, jg):
            scale = float(np.abs(want[rank]).max())
            assert float(np.abs(g - want[rank]).max()) <= 1e-5 * scale
        assert abs(out["step"][0] - float(np.mean(np.asarray(jl)))) <= 1e-6
    # the sync the step made: the reference's over the pods' own
    # gradients, exact where the keep masks agree.  The leaves go to the
    # reference flat (the sync is elementwise but for each leaf's sum and
    # max), so it compiles one eager op per leaf size, not per shape
    stacked = {str(i): np.stack([o["local"][1][i].ravel() for o in outs])
               for i in range(len(jg))}
    want = _vmapped(lambda x: jdist.anycost_gradient_sync(
        x, "pod", keep_frac=TRAIN_KEEP), stacked)
    for rank, out in enumerate(outs):
        got = {str(i): g.ravel() for i, g in enumerate(out["step"][1])}
        _same_where_masks_agree(got, {k: v[rank] for k, v in want.items()},
                                stacked, TRAIN_KEEP)
    # the update: p - lr * synced, the same on both ranks
    for p, g, new in zip(jax.tree.leaves(params), outs[0]["step"][1],
                         outs[0]["step"][2]):
        np.testing.assert_array_equal(
            new, (torch.tensor(p) - torch.tensor(g) * torch.tensor(
                LR, dtype=torch.float32)).numpy())


def test_every_sync_raises_without_a_process_group():
    import torch.distributed as dist
    assert not dist.is_initialized()
    g = _pod(RAND, 0)
    for call in (
            lambda: distributed.anycost_gradient_sync(g, "pod"),
            lambda: distributed.anycost_sync_leaf(g["w"], "pod"),
            lambda: distributed.mean_gradient_sync(g, "pod"),
            lambda: distributed.anycost_gradient_sync_ef(
                g, distributed.init_error_feedback(g)),
            lambda: distributed.mesh_cell_aggregate(
                *(torch.tensor(x) for x in _cells())),
            tmesh.make_host_mesh, tmesh.make_pod_mesh,
            tmesh.make_production_mesh):
        with pytest.raises(RuntimeError, match="process group"):
            call()


def test_anycost_train_step_needs_the_mesh():
    model = build_model(configs.get_config(ARCH).reduced())
    with pytest.raises(ValueError, match="needs the mesh"):
        steps.make_train_step(model, optimizer.sgd(LR),
                              grad_sync="anycost")


def test_mesh_route_falls_back_without_a_group(capsys):
    sim = runner.Simulation(FLRunConfig(**TINY), FleetConfig(
        n_devices=4, topology=TopologyConfig(kind="hier", n_cells=2)),
        device="cpu")
    assert sim.resolve_agg_route("mesh") == "streaming"
    assert "needs >= 2 devices" in capsys.readouterr().out
