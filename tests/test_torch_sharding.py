"""The port's logical-axis sharding (``repro_torch/sharding.py``, the
logical axes on every model, ``launch/steps``'s shardings and sharded
train step) against the JAX package on the CPU.

* Logical axes and abstract shapes: every assigned arch at published size
  and both CNNs, leaf by leaf, equal.
* Rule translation: the reference's ``tests/test_sharding_rules.py``
  cases on a one-rank host mesh (a one-rank gloo group in this process).
* Layouts: every parameter, optimizer-state, batch and cache spec of
  every arch x input shape on the production meshes (single pod 16x16,
  two pods 2x16x16), and the ``"anycost"`` rules for train, equal the
  reference's ``PartitionSpec``s on a device-free ``AbstractMesh``.  The
  port's side runs in one subprocess that joins a fake 512-rank group.
* Numerics: two gloo ranks spawned for the module (a ``FileStore`` under
  ``tmp_path``).  One float32 train step of reduced qwen2-7b and of
  reduced granite-moe-1b-a400m on the host mesh (data=1, model=2), each
  within 1e-5 of the reference's unsharded ``make_train_step`` (the loss;
  each gradient leaf and each updated parameter of a leaf's largest
  magnitude), the parameters carried over with ``bridge``.  The
  ``"anycost"`` step on (pod=2, data=1, model=1) equals the one-rank-a-pod
  step of ``launch/mesh.make_pod_mesh`` bit for bit, and the reference's
  sync under ``jax.vmap(axis_name="pod")`` exactly where the keep masks
  agree, at most one keep decision apart (``test_torch_distributed``'s
  bounds).  On a one-rank mesh the sharded step equals the unsharded
  port step bit for bit.  The synchronous functional collectives that a
  cuda mesh over gloo registers give torch's values bit for bit.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import sharding as jshd  # noqa: E402
from repro.core import distributed as jdist  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import loss_fn as jloss  # noqa: E402
from repro.train import optimizer as joptimizer  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch import sharding as shd  # noqa: E402
from repro_torch.core import distributed  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import optimizer  # noqa: E402
from repro_torch.utils.pytree import tree_leaves, tree_map  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 2
B, S = 4, 16
LR = 0.1
TRAIN_KEEP = 0.25
MAX_FLIPS = 1
RTOL = 1e-5
STEP_ARCHS = ("qwen2-7b", "granite-moe-1b-a400m")
ALL_ARCHS = tuple(jconfigs.ASSIGNED_ARCHS) + ("fmnist-cnn", "vgg9-cifar")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _spec(x):
    """A spec as nested lists, entry by entry (the reference's or the
    port's)."""
    return [list(e) if isinstance(e, tuple) else e for e in tuple(x)]


# ---------------------------------------------------- axes and shapes

@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_logical_axes_and_abstract_params_match_the_reference(arch):
    jm = jbuild(jconfigs.get_config(arch))
    tm = build_model(configs.get_config(arch))
    jax_axes = jax.tree.leaves(jm.logical_axes(),
                               is_leaf=lambda x: isinstance(x, jL.LogicalAxes))
    port_axes = tree_leaves(tm.logical_axes())
    assert [a.names for a in port_axes] == [a.names for a in jax_axes]
    jax_shapes = jax.tree.leaves(jm.abstract_params())
    port_shapes = tree_leaves(tm.abstract_params())
    assert len(port_shapes) == len(jax_shapes)
    for t, s in zip(port_shapes, jax_shapes):
        assert t.device.type == "meta"
        assert tuple(t.shape) == s.shape
        assert str(t.dtype) == f"torch.{jnp.dtype(s.dtype).name}"


def test_seeded_initialisation_is_the_same_with_and_without_axes():
    """The axes mode draws nothing: an init after one equals one before."""
    tm = build_model(configs.get_config("falcon-mamba-7b").reduced())
    a = tm.init(torch.Generator().manual_seed(3))
    tm.logical_axes()
    tm.abstract_params()
    b = tm.init(torch.Generator().manual_seed(3))
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# ------------------------------------------------- rule translation

@pytest.fixture(scope="module")
def host_mesh():
    """A one-rank gloo group in this process and its host mesh."""
    import torch.distributed as dist
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield tmesh.make_host_mesh("cpu")
    finally:
        dist.destroy_process_group()


def test_identity_outside_context():
    x = torch.ones(4, 4)
    assert shd.lc(x, ("batch", "embed")) is x
    assert not shd.active()
    assert shd.spec_for(("fsdp", "tp")) == shd.P()
    assert shd.sharding_for((4, 4), ("fsdp", "tp")) is None


def test_spec_translation(host_mesh):
    with shd.use_sharding(host_mesh):
        assert shd.spec_for(("fsdp", "tp")) == shd.P("data", "model")
        assert shd.spec_for((None, "nope")) == shd.P(None, None)


def test_missing_mesh_axis_dropped(host_mesh):
    with shd.use_sharding(host_mesh):
        assert shd.spec_for(("batch",)) == shd.P("data")


def test_duplicate_mesh_axis_suppressed(host_mesh):
    with shd.use_sharding(host_mesh, {"x1": "model", "x2": "model"}):
        assert shd.spec_for(("x1", "x2")) == shd.P("model", None)


def test_safe_spec_divisibility(host_mesh):
    with shd.use_sharding(host_mesh, {"v": "model"}):
        assert shd.safe_spec((3, 4), ("v", None))[0] == "model"
        assert shd.mesh_axis_size("model") == 1


def test_rules_override(host_mesh):
    with shd.use_sharding(host_mesh, {"cache_seq": "model"}):
        assert shd.spec_for(("cache_seq",)) == shd.P("model")


def test_safe_spec_fallbacks_match_the_reference():
    """Divisibility fallbacks and prefix keeping on the production
    shapes, against the reference, on the mesh sizes alone."""
    jmesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    cases = [((64, 8), ("batch", None)), ((16, 8), ("batch", None)),
             ((2, 8), ("batch", None)), ((1, 8), ("batch", None)),
             ((24, 48), ("fsdp", "tp")), ((3, 7), ("vocab", "embed_fsdp"))]
    with jshd.use_sharding(jmesh):
        want = [_spec(jshd.safe_spec(s, a)) for s, a in cases]
    shd._CTX.rules = {k: v for k, v in shd.DEFAULT_RULES.items()}
    shd._CTX.sizes = {"pod": 2, "data": 16, "model": 16}
    try:
        got = [_spec(shd._safe(s, a, shd._CTX.rules, shd._CTX.sizes))
               for s, a in cases]
    finally:
        shd._CTX.rules, shd._CTX.sizes = {}, {}
    assert got == want


def test_placements_follow_the_spec_and_check_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    sizes = {"data": 2, "model": 4}
    assert shd.placements_for(shd.P(None, "model"), sizes) \
        == (Replicate(), Shard(1))
    assert shd.placements_for(shd.P(("data", "model"),), sizes) \
        == (Shard(0), Shard(0))
    # one rank on an axis holds the whole dimension: replicated
    assert shd.placements_for(shd.P("data", "model"),
                              {"data": 1, "model": 2}) \
        == (Replicate(), Shard(1))
    # "pod" is manual, never a DTensor placement
    assert shd.placements_for(shd.P(("pod", "data")), sizes) \
        == (Shard(0), Replicate())
    with pytest.raises(ValueError, match="mesh order"):
        shd.placements_for(shd.P(("model", "data"),), sizes)


def test_lc_on_a_plain_tensor_in_a_context_is_the_identity(host_mesh):
    x = torch.ones(2, 3, 4)
    with shd.use_sharding(host_mesh):
        assert shd.lc(x, ("batch", "seq", "embed")) is x
        with pytest.raises(ValueError, match="logical axes"):
            shd.lc(x, ("batch", "seq"))


def test_a_gloo_mesh_made_for_the_cpu_says_cpu(host_mesh):
    assert host_mesh.device_type == "cpu"
    assert tmesh.device_type() == ("cuda" if torch.cuda.is_available()
                                   else "cpu")
    assert tmesh.device_type("cuda:0") == "cuda"


def test_one_rank_sharded_step_equals_the_unsharded_step(host_mesh):
    model = build_model(configs.get_config("qwen2-7b").reduced())
    opt = optimizer.adamw(3e-3, warmup=10)
    init = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, 512, (B, S)), dtype=torch.int32)}
    plain = tree_map(torch.clone, init)
    plain_state = opt.init(plain)
    step = steps.make_train_step(model, opt, remat="full")
    for _ in range(2):
        plain, plain_state, want = step(plain, plain_state, batch)
    with shd.use_sharding(host_mesh):
        sharded = steps.distribute(tree_map(torch.clone, init),
                                   steps.param_shardings(model))
        state = steps.distribute(opt.init(sharded),
                                 steps.opt_state_shardings(opt, model))
        for _ in range(2):
            sharded, state, got = step(sharded, state, batch)
    assert float(got) == float(want)
    for x, y in zip(tree_leaves(sharded), tree_leaves(plain)):
        assert shd.is_dtensor(x)
        assert torch.equal(x.full_tensor(), y)
    for x, y in zip(tree_leaves(state["v"]), tree_leaves(plain_state["v"])):
        assert torch.equal(x.full_tensor(), y)


# ---------------------------------------------------------- layouts

PORT_SPECS = r"""
import json, sys
import torch
from repro_torch import sharding as shd
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import adamw
from repro_torch.utils.pytree import tree_leaves

dryrun.fake_group(512)

def specs(tree):
    return [[list(e) if isinstance(e, tuple) else e for e in s.spec]
            for s in tree_leaves(tree)]

out = {}
for kind, (shape, axes) in json.loads(sys.argv[1]).items():
    mesh = make_mesh(tuple(shape), tuple(axes), "cpu")
    for arch in ASSIGNED_ARCHS:
        for name in INPUT_SHAPES:
            entry = dryrun.plan_entry(arch, name)
            if entry is None:
                continue
            cfg, shape_, _ = entry
            model = build_model(cfg)
            for gs in (("auto", "anycost") if shape_.kind == "train"
                       else ("auto",)):
                with shd.use_sharding(mesh, steps.rules_for(shape_, gs)):
                    got = {"params": specs(steps.param_shardings(model)),
                           "batch": specs(steps.batch_shardings(cfg,
                                                                shape_))}
                    if shape_.kind == "train":
                        o = steps.opt_state_shardings(adamw(1e-3), model)
                        got["opt"] = {k: specs(v) for k, v in o.items()}
                    if shape_.kind == "decode":
                        got["cache"] = specs(steps.cache_shardings(model,
                                                                   shape_))
                out[f"{kind}|{arch}|{name}|{gs}"] = got
print(json.dumps(out))
"""


def _reference_specs():
    def specs(tree):
        return [_spec(s.spec) for s in jax.tree.leaves(
            tree, is_leaf=lambda x: hasattr(x, "spec"))]

    out = {}
    for kind, (shape, axes) in MESHES.items():
        mesh = AbstractMesh(shape, axes)
        for arch in jconfigs.ASSIGNED_ARCHS:
            for name in jconfigs.INPUT_SHAPES:
                entry = jdryrun.plan_entry(arch, name)
                if entry is None:
                    continue
                cfg, shape_, _ = entry
                model = jbuild(cfg)
                for gs in (("auto", "anycost") if shape_.kind == "train"
                           else ("auto",)):
                    with jshd.use_sharding(mesh, jsteps.rules_for(shape_,
                                                                  gs)):
                        want = {"params": specs(jsteps.param_shardings(
                            model)), "batch": specs(jsteps.batch_shardings(
                                cfg, shape_))}
                        if shape_.kind == "train":
                            o = jsteps.opt_state_shardings(
                                joptimizer.adamw(1e-3), model)
                            want["opt"] = {k: specs(v) for k, v in o.items()}
                        if shape_.kind == "decode":
                            want["cache"] = specs(jsteps.cache_shardings(
                                model, shape_))
                    out[f"{kind}|{arch}|{name}|{gs}"] = want
    return out


def test_every_placement_spec_matches_the_reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run([sys.executable, "-c", PORT_SPECS,
                          json.dumps(MESHES)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    want = _reference_specs()
    assert sorted(got) == sorted(want)
    assert len(got) == 2 * (39 + 10)
    for key in want:
        assert got[key] == want[key], key


# --------------------------------------------------- two-rank numerics

def _np(tree):
    return [t.detach().numpy().copy() for t in tree_leaves(tree)]


def _whole(tree):
    return tree_map(lambda t: t.full_tensor() if shd.is_dtensor(t) else t,
                    tree)


def _recording_sgd(seen):
    sgd = optimizer.sgd(LR)

    def update(p, g, s):
        seen["grads"] = _np(_whole(g))
        return sgd.update(p, g, s)

    return optimizer.Optimizer(sgd.init, update)


def _load(out_dir, arch):
    data = np.load(os.path.join(out_dir, f"{arch}.npz"))
    flat = {k[2:]: v for k, v in data.items() if k.startswith("p.")}
    tree = {}
    for path, v in flat.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree, data["tokens"]


def _rank_main(rank, store, out_dir):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    out = {}
    host = tmesh.make_host_mesh("cpu")
    for arch in STEP_ARCHS:
        model = build_model(configs.get_config(arch).reduced())
        params, tokens = _load(out_dir, arch)
        batch = {"tokens": torch.tensor(tokens)}
        seen = {}
        opt = _recording_sgd(seen)
        with shd.use_sharding(host):
            pshard = steps.param_shardings(model)
            sharded = steps.distribute(bridge.params_from_numpy(params,
                                                                "cpu"),
                                       pshard)
            local = [tuple(t.to_local().shape) for t in tree_leaves(sharded)]
            new, _, loss = steps.make_train_step(model, opt, remat="full")(
                sharded, opt.init(sharded), batch)
            out[arch] = {"loss": float(loss), "grads": seen["grads"],
                         "new": _np(_whole(new)), "local": local}
    # the "anycost" step: sharded on (pod=2, data=1, model=1), and the
    # one-rank-a-pod step beside it
    model = build_model(configs.get_config("qwen2-7b").reduced())
    params, tokens = _load(out_dir, "qwen2-7b")
    batch = {"tokens": torch.tensor(tokens)}
    shape = configs.base.InputShape("t", S, B, "train")
    mesh = tmesh.make_anycost_mesh(WORLD, "cpu")
    runs = {}
    for name, m, ctx in (
            ("sharded", mesh, lambda: shd.use_sharding(
                mesh, steps.rules_for(shape, "anycost"))),
            ("pods", tmesh.make_pod_mesh(WORLD, "cpu"), None)):
        seen = {}
        opt = _recording_sgd(seen)
        p = bridge.params_from_numpy(params, "cpu")
        step = steps.make_train_step(model, opt, remat="full",
                                     grad_sync="anycost",
                                     keep_frac=TRAIN_KEEP, mesh=m)
        if ctx is None:
            new, _, loss = step(p, opt.init(p), batch)
        else:
            with ctx():
                p = steps.distribute(p, steps.param_shardings(model))
                new, _, loss = step(p, opt.init(p), batch)
        runs[name] = {"loss": float(loss), "grads": seen["grads"],
                      "new": _np(_whole(new))}
    rows = B // WORLD
    _, own = steps.value_and_grad(
        model, bridge.params_from_numpy(params, "cpu"),
        {"tokens": batch["tokens"][rank * rows:(rank + 1) * rows]},
        remat="full")
    runs["local"] = _np(own)
    out["anycost"] = runs
    # the synchronous functional collectives a cuda mesh over gloo
    # registers, here for CPU tensors: the same values as torch's own
    import torch.distributed._functional_collectives as funcol
    g = dist.group.WORLD
    x = torch.arange(12.0).view(6, 2) + rank

    def issue():
        return [torch.as_tensor(t).clone() for t in (
            funcol.all_gather_tensor(x, 1, g), funcol.all_reduce(x, "avg", g),
            funcol.reduce_scatter_tensor(x, "sum", 0, g),
            funcol.all_to_all_single(x, [3, 3], [3, 3], g))]

    before = issue()
    tmesh.sync_functional_collectives("CPU")
    out["sync_collectives"] = (before, issue())
    try:
        funcol.all_reduce(torch.arange(4) + rank, "avg", g)
        out["sync_int_avg"] = None
    except (TypeError, RuntimeError) as e:
        out["sync_int_avg"] = str(e)
    model = build_model(configs.get_config("qwen2-7b").reduced())
    params, tokens = _load(out_dir, "qwen2-7b")
    seen = {}
    opt = _recording_sgd(seen)
    with shd.use_sharding(host):
        p = steps.distribute(bridge.params_from_numpy(params, "cpu"),
                             steps.param_shardings(model))
        new, _, loss = steps.make_train_step(model, opt, remat="full")(
            p, opt.init(p), {"tokens": torch.tensor(tokens)})
    out["sync_step"] = {"loss": float(loss), "grads": seen["grads"],
                        "new": _np(_whole(new))}
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _flat_paths(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_paths(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    d = tmp_path_factory.mktemp("sharded")
    inputs = {}
    for i, arch in enumerate(STEP_ARCHS):
        params = bridge.params_to_numpy(build_model(configs.get_config(
            arch).reduced()).init(torch.Generator().manual_seed(i), "cpu"))
        tokens = np.random.default_rng(10 + i).integers(
            0, 512, (B, S)).astype(np.int32)
        np.savez(d / f"{arch}.npz", tokens=tokens,
                 **{f"p.{k}": v for k, v in _flat_paths(params).items()})
        inputs[arch] = (params, tokens)
    mp.start_processes(_rank_main, args=(str(d / "store"), str(d)),
                       nprocs=WORLD, start_method="spawn")
    outs = [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]
    return {"outs": outs, "inputs": inputs}


def _reference_step(arch, params, tokens):
    jm = jbuild(jconfigs.get_config(arch).reduced())
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, t: jloss(jm, p, {"tokens": t}, remat="full")))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    new = jax.tree.map(lambda p, g: p - LR * g, params, grads)
    return (float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)],
            [np.asarray(p) for p in jax.tree.leaves(new)])


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_two_rank_sharded_step_matches_the_reference(ranks, arch):
    params, tokens = ranks["inputs"][arch]
    jl, jg, jnew = _reference_step(arch, params, tokens)
    a, b = (o[arch] for o in ranks["outs"])
    assert a["loss"] == b["loss"]
    assert abs(a["loss"] - jl) <= RTOL
    for got, want in zip(a["grads"], jg):
        assert float(np.abs(got - want).max()) \
            <= RTOL * float(np.abs(want).max())
    for got, other, want in zip(a["new"], b["new"], jnew):
        np.testing.assert_array_equal(got, other)
        assert float(np.abs(got - want).max()) \
            <= RTOL * float(np.abs(want).max())
    # the model axis splits every "tp", "heads" and "vocab" leaf in two
    whole = [tuple(np.shape(x)) for x in jax.tree.leaves(params)]
    halved = sum(np.prod(lo) * 2 == np.prod(w)
                 for lo, w in zip(a["local"], whole))
    assert halved >= len(whole) // 2 and a["local"] == b["local"]


def test_sharded_anycost_step_equals_the_pod_step_and_the_reference(ranks):
    """The sync the sharded step made: the reference's over the pods' own
    gradients, exact where the keep masks agree."""
    params, tokens = ranks["inputs"]["qwen2-7b"]
    jm = jbuild(jconfigs.get_config("qwen2-7b").reduced())
    per_pod = tokens.reshape(WORLD, B // WORLD, S)
    jl, _ = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, t: jloss(jm, p, {"tokens": t}, remat="full")),
        in_axes=(None, 0)))(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(per_pod))
    outs = [o["anycost"] for o in ranks["outs"]]
    stacked = {str(i): np.stack([o["local"][i].ravel() for o in outs])
               for i in range(len(outs[0]["local"]))}
    want = jax.tree.map(np.asarray, jax.vmap(
        lambda x: jdist.anycost_gradient_sync(x, "pod",
                                              keep_frac=TRAIN_KEEP),
        axis_name="pod")(jax.tree.map(jnp.asarray, stacked)))
    agree, flips = {}, 0
    for k, v in stacked.items():
        thr = np.asarray(jax.vmap(lambda x: jdist.magnitude_threshold(
            x, TRAIN_KEEP))(jnp.asarray(v)))
        ref_keep = np.abs(v) >= thr[:, None]
        port_keep = np.stack([distributed._local_compress(
            torch.tensor(x), TRAIN_KEEP, False)[0].numpy() for x in v])
        differ = ref_keep != port_keep
        flips += int(differ.sum())
        agree[k] = ~differ.any(axis=0)
    assert flips <= MAX_FLIPS
    for rank, out in enumerate(outs):
        got, pods = out["sharded"], out["pods"]
        assert got["loss"] == pods["loss"]
        for x, y in zip(got["grads"] + got["new"],
                        pods["grads"] + pods["new"]):
            np.testing.assert_array_equal(x, y)
        assert abs(got["loss"] - float(np.mean(np.asarray(jl)))) <= 1e-6
        for i, g in enumerate(got["grads"]):
            k = str(i)
            np.testing.assert_array_equal(g.ravel()[agree[k]],
                                          want[k][rank][agree[k]])


def test_sync_functional_collectives_give_torchs_values(ranks):
    """The kernels a cuda mesh over gloo registers (``launch/mesh``),
    registered here for CPU tensors, give the functional collectives'
    values bit for bit, refuse an integer average rather than truncate
    it, and a sharded step through them gives the same step."""
    for out in ranks["outs"]:
        before, after = out["sync_collectives"]
        for x, y in zip(before, after):
            assert torch.equal(x, y)
        assert out["sync_int_avg"] and "avg" in out["sync_int_avg"]
        got, want = out["sync_step"], out["qwen2-7b"]
        assert got["loss"] == want["loss"]
        for x, y in zip(got["grads"] + got["new"],
                        want["grads"] + want["new"]):
            np.testing.assert_array_equal(x, y)
