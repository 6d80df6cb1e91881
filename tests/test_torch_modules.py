"""The port's modules against the JAX package's, one module at a time.

Narrow fmnist-cnn widths (``d_model=4, d_ff=16``), inputs from a seeded
numpy generator, the same numbers handed to both sides.  Where the
reference draws uniforms from a key, the port gets the same draw
(``jax.random.uniform(key, (N,))``).  Tolerances: data draws, strategies,
permutations, shrinking, masks and level indices exact; logits and
gradients atol 1e-5; float32 values and bits rtol 1e-5 (sums taken in
another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.core import anycost as janycost  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import shrinking as jshrink  # noqa: E402
from repro.data import partition as jpart  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import registry as jreg  # noqa: E402
from repro.sysmodel import population as jpop  # noqa: E402
from repro.utils import pytree as jtree  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import aggregation, anycost, compression  # noqa: E402
from repro_torch.core import schedule, shrinking  # noqa: E402
from repro_torch.data import partition, synthetic  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.sysmodel import population  # noqa: E402
from repro_torch.utils import pytree  # noqa: E402

torch.set_num_threads(1)

NARROW = dict(d_model=4, d_ff=16)


def _cfgs(arch="fmnist-cnn"):
    return (dataclasses.replace(jax_get_config(arch), **NARROW),
            dataclasses.replace(get_config(arch), **NARROW))


def _jax_params(jcfg, seed=0):
    """Parameters of the reference model's shapes, drawn with numpy at the
    reference's init scale (scale / sqrt(fan_in)); biases random too, so
    that they take part in every comparison."""
    tcfg = dataclasses.replace(get_config(jcfg.name), d_model=jcfg.d_model,
                               d_ff=jcfg.d_ff)
    shapes = registry.build_model(tcfg).init(torch.Generator())
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) > 1 else 1
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return pytree.tree_map(draw, shapes)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(got, want):
    want = jax.tree.map(np.asarray, want)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_equal(got[k], want[k])
        else:
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def _batch(rng, B, shape=(28, 28, 1)):
    return {"images": rng.uniform(size=(B, *shape)).astype(np.float32),
            "labels": rng.integers(0, 10, B).astype(np.int32)}


# ------------------------------------------------------------ pytree, bridge

def test_flatten_order_and_bridge_round_trip():
    jcfg, _ = _cfgs()
    params = _jax_params(jcfg)
    tp = bridge.params_from_numpy(params, "cpu")
    vec, unflatten = pytree.flatten_to_vector(tp)
    jvec, _ = jtree.flatten_to_vector(params)
    np.testing.assert_array_equal(vec.numpy(), np.asarray(jvec))
    assert pytree.tree_size(tp) == jtree.tree_size(params)
    np.testing.assert_allclose(float(pytree.tree_l2(tp)),
                               float(jtree.tree_l2(params)), rtol=1e-6)
    _assert_tree_equal(unflatten(vec), params)
    back = bridge.params_to_numpy(tp)
    _assert_tree_equal(bridge.params_from_numpy(back, "cpu"), params)


# -------------------------------------------------------------------- models

@pytest.mark.parametrize("arch,shape", [("fmnist-cnn", (28, 28, 1)),
                                        ("vgg9-cifar", (32, 32, 3))])
def test_logits_and_gradients_match_jax(arch, shape):
    jcfg, tcfg = _cfgs(arch)
    params = _jax_params(jcfg, seed=1)
    batch = _batch(np.random.default_rng(0), 6, shape)
    jmodel, tmodel = jreg.build_model(jcfg), registry.build_model(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tp = bridge.params_from_numpy(params, "cpu")
    np.testing.assert_allclose(
        tmodel.forward(tp, tb).detach().numpy(),
        np.asarray(jax.jit(jmodel.forward)(params, jb)), atol=1e-5)
    jgrad = _np(jax.jit(jax.grad(
        lambda p: jreg.loss_fn(jmodel, p, jb)))(params))
    leaves = [t.requires_grad_() for t in pytree.tree_leaves(tp)]
    loss = registry.loss_fn(tmodel, pytree.tree_unflatten(tp, leaves), tb)
    grads = torch.autograd.grad(loss, leaves)
    for g, want in zip(grads, jax.tree_util.tree_leaves(jgrad)):
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5)


def test_init_follows_the_reference_scales():
    _, tcfg = _cfgs()
    p = registry.build_model(tcfg).init(torch.Generator().manual_seed(0))
    assert tuple(p["conv2"]["w"].shape) == (5, 5, 4, 8)
    assert tuple(p["dense1"]["w"].shape) == (7 * 7 * 8, 16)
    assert float(p["dense1"]["b"].abs().sum()) == 0.0
    # std = sqrt(2)/sqrt(fan_in) for convs, 1/sqrt(fan_in) for linears
    big = registry.build_model(get_config("fmnist-cnn")).init(
        torch.Generator().manual_seed(0))
    np.testing.assert_allclose(float(big["conv2"]["w"].std()),
                               np.sqrt(2.0 / (25 * 32)), rtol=0.02)
    np.testing.assert_allclose(float(big["dense1"]["w"].std()),
                               np.sqrt(1.0 / 3136), rtol=0.02)


# ---------------------------------------------------------------------- data

@pytest.mark.parametrize("fleet_kw", [
    {}, dict(eps_var_scale=2.0, dist_mean_m=200.0, dist_var_scale=0.5)])
def test_data_and_fleet_draws_match(fleet_kw):
    a, b = np.random.default_rng(4), np.random.default_rng(4)
    jtr, jte = jsyn.make_image_task(a, 40, 12, shape=(28, 28, 1))
    ttr, tte = synthetic.make_image_task(b, 40, 12, shape=(28, 28, 1))
    for x, y in ((jtr, ttr), (jte, tte)):
        np.testing.assert_array_equal(x.x, y.x)
        np.testing.assert_array_equal(x.y, y.y)
    for u, v in zip(jpart.partition_iid(a, 40, 3),
                    partition.partition_iid(b, 40, 3)):
        np.testing.assert_array_equal(u, v)
    for u, v in zip(jpart.partition_dirichlet(a, jtr.y, 3),
                    partition.partition_dirichlet(b, ttr.y, 3)):
        np.testing.assert_array_equal(u, v)
    sizes = np.array([13, 13, 14])
    jf = jpop.make_fleet(a, jpop.FleetConfig(n_devices=3, **fleet_kw), sizes)
    tf = population.make_fleet(
        b, population.FleetConfig(n_devices=3, **fleet_kw), sizes)
    for _ in range(2):
        for je, te in zip(jf.round_envs(a, 1e6, 3.2e7),
                          tf.round_envs(b, 1e6, 3.2e7)):
            assert dataclasses.asdict(je) == dataclasses.asdict(te)
            assert dataclasses.asdict(jsched.solve(je)) == \
                dataclasses.asdict(schedule.solve(te))
    assert a.bit_generator.state == b.bit_generator.state


def test_fleet_features_outside_the_slice_raise(monkeypatch, capsys):
    """Fleet dynamics, device motion and handover are ported (they build
    and attach their state); the mesh route of the hierarchy falls back
    to the streaming fold on one device and is kept over two or more
    (``tests/test_torch_distributed.py`` runs it on two ranks)."""
    from repro_torch.fleet import AvailabilityConfig, FleetDynamicsConfig
    from repro_torch.mobility import HandoverConfig, MobilityConfig
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.topology import TopologyConfig
    cfg = population.FleetConfig(
        n_devices=2, dynamics=FleetDynamicsConfig(
            availability=AvailabilityConfig(kind="markov")),
        mobility=MobilityConfig(kind="random_waypoint"),
        topology=TopologyConfig(kind="hier", n_cells=2,
                                handover=HandoverConfig()))
    fleet = population.make_fleet(np.random.default_rng(0), cfg,
                                  np.array([1, 1]))
    assert fleet.trace is not None and fleet.mobility is not None
    from repro_torch.orchestrator import runner
    from repro_torch.train.fl_loop import FLRunConfig
    sim = runner.Simulation(FLRunConfig(rounds=1, n_train=64, n_test=32,
                                        use_planner=False),
                            cfg, device="cpu")
    assert OrchestratorConfig(agg_route="mesh").agg_route == "mesh"
    assert sim.resolve_agg_route("mesh") == "streaming"
    assert "falling back to the streaming edge fold" \
        in capsys.readouterr().out
    # a process group of two: the cells are folded over its ranks
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    assert sim.resolve_agg_route("mesh") == "mesh"


# ------------------------------------------------------------------------ EMS

@pytest.mark.parametrize("alpha", [0.25, 0.55, 0.85, 1.0])
def test_sort_shrink_expand_match_exactly(alpha):
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=2)
    jspec, tspec = jshrink.cnn_shrink_spec(jcfg), shrinking.cnn_shrink_spec(
        tcfg)
    assert jspec.widths(alpha) == tspec.widths(alpha)
    js, jperms = jshrink.sort_channels(params, jspec, return_perms=True)
    ts, tperms = shrinking.sort_channels(
        bridge.params_from_numpy(params, "cpu"), tspec, return_perms=True)
    _assert_tree_equal(ts, js)
    for tp, jp in zip(tperms, jperms):
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jsub, tsub = jshrink.shrink(js, alpha, jspec), shrinking.shrink(
        ts, alpha, tspec)
    _assert_tree_equal(tsub, jsub)
    rng = np.random.default_rng(3)
    upd = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32), _np(jsub))
    jfull, jmask = jshrink.expand_update(upd, js, alpha, jspec)
    tfull, tmask = shrinking.expand_update(
        bridge.params_from_numpy(upd, "cpu"), ts, alpha, tspec)
    _assert_tree_equal(tfull, jfull)
    _assert_tree_equal(tmask, jmask)


def test_sort_is_stable_on_ties():
    _, tcfg = _cfgs()
    spec = shrinking.cnn_shrink_spec(tcfg)
    p = registry.build_model(tcfg).init(torch.Generator().manual_seed(0))
    p["conv1"]["w"] = torch.ones_like(p["conv1"]["w"])
    _, perms = shrinking.sort_channels(p, spec, return_perms=True)
    np.testing.assert_array_equal(perms[0].numpy(), np.arange(4))


# ------------------------------------------------------------------------ FGC

def _update_tree(seed=5):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (rng.standard_normal(x.shape) * 1e-2).astype(np.float32),
        _jax_params(jcfg))


def test_kernel_segments_match():
    upd = _update_tree()
    jseg, jK = jcomp.kernel_segments(upd)
    tseg, tK = compression.kernel_segments(bridge.params_from_numpy(upd,
                                                                     "cpu"))
    assert jK == tK
    np.testing.assert_array_equal(tseg, jseg)


def test_kept_count_is_float32_like_the_reference():
    rng = np.random.default_rng(6)
    norms = rng.uniform(size=622).astype(np.float32)
    tn = torch.tensor(norms)
    # every rho on a fine grid: a float64 kept count would move by one
    # somewhere on it
    rhos = np.linspace(0.0, 1.0, 2001).astype(np.float32)
    want = np.asarray(jax.vmap(lambda r: jcomp.sparsify_threshold(
        jnp.asarray(norms), r))(jnp.asarray(rhos)))
    got = [float(compression.sparsify_threshold(tn, float(r)))
           for r in rhos]
    np.testing.assert_array_equal(np.asarray(got, np.float32), want)


def test_beta_split_is_float32():
    for beta in (1e-3, 0.0123, 1.0 / 15.0, 0.5):
        assert compression.analytic_rho(beta) == float(
            jcomp.analytic_rho(beta))
        assert compression.analytic_levels(beta) == float(
            jcomp.analytic_levels(beta))


@pytest.mark.parametrize("n_levels", [2, 37.25, 1024])
def test_quantize_and_size_model_match(n_levels):
    rng = np.random.default_rng(7)
    v = rng.standard_normal(4000).astype(np.float32)
    mask = (rng.uniform(size=4000) > 0.4).astype(np.float32)
    key = jax.random.PRNGKey(9)
    rand = torch.tensor(np.asarray(jax.random.uniform(key, v.shape)))
    jq = jcomp.prob_quantize(jnp.asarray(v), jnp.asarray(mask), n_levels, key)
    tq = compression.prob_quantize(torch.tensor(v), torch.tensor(mask),
                                   n_levels, rand)
    np.testing.assert_array_equal(tq.levels.numpy(), np.asarray(jq.levels))
    np.testing.assert_allclose(tq.values.numpy(), np.asarray(jq.values),
                               rtol=1e-6)
    assert float(tq.u_min) == float(jq.u_min)
    assert float(tq.u_max) == float(jq.u_max)
    np.testing.assert_allclose(
        float(compression.compressed_bits(tq, torch.tensor(mask), 65535)),
        float(jcomp.compressed_bits(jq, jnp.asarray(mask), 65535)),
        rtol=1e-5)


@pytest.mark.parametrize("beta,rho,levels", [(0.02, None, None),
                                             (1.0 / 15.0, None, None),
                                             (0.05, 0.8, 64.0),
                                             (0.05, 0.0, 2.0)])
def test_compress_update_matches(beta, rho, levels):
    upd = _update_tree()
    key = jax.random.PRNGKey(11)
    n = jtree.tree_size(upd)
    rand = torch.tensor(np.asarray(jax.random.uniform(key, (n,))))
    kw = {} if rho is None else dict(rho=jnp.float32(rho),
                                     n_levels=jnp.float32(levels))
    jc = jcomp.compress_update(upd, beta, key, **kw)
    tkw = {} if rho is None else dict(rho=rho, n_levels=levels)
    tc = compression.compress_update(bridge.params_from_numpy(upd, "cpu"),
                                     beta, rand, **tkw)
    _assert_tree_equal(tc.mask, jc.mask)
    for g, w in zip(pytree.tree_leaves(tc.values),
                    jax.tree_util.tree_leaves(jc.values)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    np.testing.assert_allclose(float(tc.bits), float(jc.bits), rtol=1e-5)
    # the kernel route's level indices against the reference composition
    jvec, _ = jtree.flatten_to_vector(upd)
    seg, K = jcomp.kernel_segments(upd)
    jmask = jcomp.sparsify_mask(jvec, seg, K, jc.rho)
    jq = jcomp.prob_quantize(jvec, jmask, jc.n_levels, key)
    tvec, _ = pytree.flatten_to_vector(bridge.params_from_numpy(upd, "cpu"))
    shapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(upd)]
    fgc = compression._sparsify_quantize(
        tvec, shapes, compression._norms(tvec, shapes), tc.rho, tc.n_levels,
        rand, 65535)
    np.testing.assert_array_equal(fgc.levels.numpy(), np.asarray(jq.levels))
    np.testing.assert_array_equal(fgc.mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(
        compression.sparsify_mask(tvec, seg, K, tc.rho).numpy(),
        np.asarray(jmask))


def test_beta_planner_fit_matches():
    upd = _update_tree(8)
    key = jax.random.PRNGKey(12)
    n = jtree.tree_size(upd)
    rand = torch.tensor(np.asarray(jax.random.uniform(key, (n,))))
    grids = dict(rho_grid=(0.0, 0.5, 0.9), level_grid=(2, 16, 256))
    jp = jcomp.BetaPlanner.fit(upd, key, **grids)
    tp = compression.BetaPlanner.fit(bridge.params_from_numpy(upd, "cpu"),
                                     rand, **grids)
    np.testing.assert_array_equal(tp.rhos, jp.rhos)
    np.testing.assert_array_equal(tp.levels, jp.levels)
    np.testing.assert_allclose(tp.betas, jp.betas, rtol=1e-5)
    for beta in (1e-3, 0.01, 0.05):
        assert tp.plan(beta) == jp.plan(beta)


# ------------------------------------------------------------------------ AIO

def test_coefficients_and_aggregate_match():
    alphas, betas = [0.25, 0.7, 1.0], [0.01, 0.05, 1.0 / 15.0]
    np.testing.assert_allclose(
        aggregation.optimal_coefficients(alphas, betas).numpy(),
        np.asarray(jagg.optimal_coefficients(alphas, betas)), rtol=1e-6)
    np.testing.assert_allclose(
        aggregation.fedavg_coefficients([3, 5, 8]).numpy(),
        np.asarray(jagg.fedavg_coefficients([3, 5, 8])), rtol=1e-6)
    rng = np.random.default_rng(13)
    ups = [_update_tree(20 + i) for i in range(3)]
    masks = [jax.tree.map(lambda x: (rng.uniform(size=x.shape) > 0.5)
                          .astype(np.float32), u) for u in ups]
    # a coordinate quantized to zero still counts in the denominator
    ups[0]["dense2"]["b"][:] = 0.0
    w = np.asarray(jagg.optimal_coefficients(alphas, betas))
    want = jagg.aio_aggregate(ups, masks, jnp.asarray(w))
    got = aggregation.aio_aggregate(
        [bridge.params_from_numpy(u, "cpu") for u in ups],
        [bridge.params_from_numpy(m, "cpu") for m in masks], torch.tensor(w))
    for g, x in zip(pytree.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("n_dev", [1, 5])
def test_aio_aggregate_stacked_matches(n_dev):
    """The vector form over (I, N), uncovered coordinates (0) and
    coordinates quantized to zero (still in the denominator) included."""
    rng = np.random.default_rng(17 + n_dev)
    u = rng.standard_normal((n_dev, 1000)).astype(np.float32)
    m = (rng.uniform(size=u.shape) > 0.4).astype(np.float32)
    u[0, :50] = 0.0
    w = rng.uniform(0.1, 1.0, n_dev).astype(np.float32)
    want = np.asarray(jagg.aio_aggregate_stacked(
        jnp.asarray(u), jnp.asarray(m), jnp.asarray(w)))
    got = aggregation.aio_aggregate_stacked(torch.tensor(u), torch.tensor(m),
                                            w)
    assert got.dtype == torch.float32 and (want == 0).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------ a device round

def test_one_device_round_matches():
    jcfg, tcfg = _cfgs()
    params = _jax_params(jcfg, seed=3)
    jspec, tspec = jshrink.cnn_shrink_spec(jcfg), shrinking.cnn_shrink_spec(
        tcfg)
    jclient = janycost.AnycostClient(jreg.build_model(jcfg), jspec, lr=0.1,
                                     batch_size=8)
    tclient = anycost.AnycostClient(registry.build_model(tcfg), tspec,
                                    lr=0.1, batch_size=8)
    rng = np.random.default_rng(14)
    batches = {"images": rng.uniform(size=(3, 8, 28, 28, 1))
               .astype(np.float32),
               "labels": rng.integers(0, 10, (3, 8)).astype(np.int32)}
    strat = jsched.Strategy(alpha=0.6, beta=0.04, freq=1e9, phi=0.5,
                            varphi=0.5, gain=0.005, T_cmp=1.0, T_com=1.0,
                            E_cmp=1.0, E_com=1.0, feasible=True)
    alpha = janycost.bucket_alpha(strat.alpha)
    assert anycost.bucket_alpha(strat.alpha) == alpha
    key = jax.random.PRNGKey(15)
    n = jtree.tree_size(params)
    rand = torch.tensor(np.asarray(jax.random.uniform(key, (n,))))

    jsorted = jshrink.sort_channels(params, jspec)
    jsub = jshrink.shrink(jsorted, alpha, jspec)
    jtrained = jclient._local_steps(alpha, 3)(
        jsub, {k: jnp.asarray(v) for k, v in batches.items()})
    jupd = jclient.finish_round(jsorted, alpha, jtrained, strat, 3, key,
                                w_per_sample=1e5)

    tsorted = shrinking.sort_channels(bridge.params_from_numpy(params, "cpu"),
                                      tspec)
    tsub = shrinking.shrink(tsorted, alpha, tspec)
    ttrained = tclient._local_steps(
        tsub, {k: torch.tensor(v) for k, v in batches.items()})
    for g, w in zip(pytree.tree_leaves(ttrained),
                    jax.tree_util.tree_leaves(jtrained)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    tupd = tclient.finish_round(tsorted, alpha, ttrained,
                                schedule.Strategy(**dataclasses.asdict(strat)),
                                3, rand, w_per_sample=1e5)
    _assert_tree_equal(tupd.mask, jupd.mask)
    for g, w in zip(pytree.tree_leaves(tupd.values),
                    jax.tree_util.tree_leaves(jupd.values)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    np.testing.assert_allclose(tupd.bits, jupd.bits, rtol=1e-5)
    assert (tupd.alpha, tupd.n_samples, tupd.flops) == \
        (jupd.alpha, jupd.n_samples, jupd.flops)

    server = anycost.AnycostServer(registry.build_model(tcfg), tspec)
    jserver = janycost.AnycostServer(jreg.build_model(jcfg), jspec)
    got = server.aggregate(tsorted, [tupd, tupd])
    want = jserver.aggregate(jsorted, [jupd, jupd])
    for g, w in zip(pytree.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


# ------------------------------------------------- the last public surface
# pytree helpers, solve_population, the backhaul's wire factor, the edge's
# count, the session's fleet size, strided conv2d, the disabled profiler

def _np_tree(seed, dtype):
    """Nested dicts whose insertion order is not the sorted order; float32
    draws, rounded to bf16 when ``dtype`` is bf16."""
    rng = np.random.default_rng(seed)
    tree = {"z": {"w": (3, 4), "b": (4,)}, "a": (2, 3, 2),
            "m": {"y": {"k": (5,)}, "c": (1, 6)}}

    def draw(node):
        if isinstance(node, dict):
            return {k: draw(v) for k, v in node.items()}
        x = rng.standard_normal(node).astype(np.float32)
        return np.array(jnp.asarray(x, dtype), np.float32)
    return draw(tree)


def _both(tree, dtype):
    """The same numbers as a reference pytree and a port pytree."""
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    # both built in the tree's insertion order (jax.tree.map would sort)
    return (pytree.tree_map(lambda x: jnp.asarray(x, dtype), tree),
            pytree.tree_map(lambda x: torch.tensor(x).to(tdtype), tree))


def _assert_leaves_equal(got, want):
    gl = pytree.tree_leaves(got)
    wl = jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w, np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_pytree_helpers_match_the_reference(dtype):
    """Exact but ``tree_dot``: rtol 1e-6 where the products do not cancel
    (a tree with itself, with its absolute values), and within 1e-6 of
    the sum of |products| where they do (a float32 sum in another order
    than XLA's)."""
    ja, ta = _both(_np_tree(0, dtype), dtype)
    jb, tb = _both(_np_tree(1, dtype), dtype)
    assert pytree.tree_bytes(ta) == jtree.tree_bytes(ja) == \
        jtree.tree_size(ja) * (2 if dtype == jnp.bfloat16 else 4)
    _assert_leaves_equal(pytree.tree_zeros_like(ta), jtree.tree_zeros_like(ja))
    _assert_leaves_equal(pytree.tree_add(ta, tb), jtree.tree_add(ja, jb))
    for s in (0.3, -1.5, 2):
        _assert_leaves_equal(pytree.tree_scale(ta, s),
                             jtree.tree_scale(ja, s))
    for jd, td in ((jnp.bfloat16, torch.bfloat16),
                   (jnp.float32, torch.float32)):
        _assert_leaves_equal(pytree.tree_cast(tb, td),
                             jtree.tree_cast(jb, jd))
    jabs = jax.tree.map(jnp.abs, ja)
    tabs = pytree.tree_map(torch.abs, ta)
    for (x, y), (u, v) in (((ta, ta), (ja, ja)), ((ta, tabs), (ja, jabs)),
                           ((tabs, pytree.tree_cast(tabs, torch.float32)),
                            (jabs, jtree.tree_cast(jabs, jnp.float32)))):
        got, want = pytree.tree_dot(x, y), jtree.tree_dot(u, v)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got, want = pytree.tree_dot(ta, tb), jtree.tree_dot(ja, jb)
    scale = float(jtree.tree_dot(jabs, jax.tree.map(jnp.abs, jb)))
    assert abs(float(got) - float(want)) <= 1e-6 * scale
    assert pytree.tree_size(ta) == jtree.tree_size(ja)


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"),
                                 float("-inf")])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["float32", "bfloat16"])
def test_tree_any_nan_matches_the_reference(dtype, bad):
    tree = _np_tree(2, dtype)
    if bad is not None:
        tree["m"]["y"]["k"][3] = bad
    jt, tt = _both(tree, dtype)
    got = pytree.tree_any_nan(tt)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(jtree.tree_any_nan(jt)) == (bad is not None)


def test_named_leaves_and_map_named_match_the_reference():
    """``named_leaves`` walks keys sorted, ``map_named`` keeps insertion
    order; both strip the trailing dot, and a bare leaf is named ""."""
    tree = _np_tree(3, jnp.float32)
    jt, tt = _both(tree, jnp.float32)
    jnames = [n for n, _ in jtree.named_leaves(jt)]
    assert [n for n, _ in pytree.named_leaves(tt)] == jnames
    assert jnames == sorted(jnames) and jnames[0] == "a"
    for (_, g), (_, w) in zip(pytree.named_leaves(tt),
                              jtree.named_leaves(jt)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert list(pytree.named_leaves(tt["a"], "pre.")) == \
        [("pre", tt["a"])]
    assert [n for n, _ in pytree.named_leaves(tt["a"])] == \
        [n for n, _ in jtree.named_leaves(jt["a"])] == [""]

    def paths(tree):
        out = []

        def walk(node):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v)
                else:
                    out.append(v)
        walk(tree)
        return out
    tm = pytree.map_named(lambda n, x: n, tt)
    jm = jtree.map_named(lambda n, x: n, jt)
    assert tm == jm
    assert paths(tm) == paths(jm) == ["z.w", "z.b", "a", "m.y.k", "m.c"]
    assert pytree.map_named(lambda n, x: n, tt["a"], "p.") == "p"
    _assert_leaves_equal(pytree.map_named(lambda n, x: x * len(n), tt),
                         jtree.map_named(lambda n, x: x * len(n), jt))


def test_solve_population_matches_the_reference_exactly():
    a, b = np.random.default_rng(12), np.random.default_rng(12)
    sizes = np.full(12, 40)
    jf = jpop.make_fleet(a, jpop.FleetConfig(n_devices=12), sizes)
    tf = population.make_fleet(b, population.FleetConfig(n_devices=12),
                               sizes)
    jenvs, tenvs = jf.round_envs(a, 1e6, 3.2e7), tf.round_envs(b, 1e6, 3.2e7)
    got = schedule.solve_population(tenvs)
    want = jsched.solve_population(jenvs)
    assert len(got) == len(want) == 12
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want] == \
        [dataclasses.asdict(schedule.solve(e)) for e in tenvs]


def test_backhaul_costs_and_wire_factor_match_the_reference():
    """The reference's own cases (``tests/test_topology.py``), both
    sides: the wire factor derived from the codec unless overridden, the
    modelled payload and its (latency, energy)."""
    from repro import topology as jtopo
    from repro_torch import topology
    for mod in (jtopo, topology):
        B = mod.BackhaulConfig
        assert B.zero_cost().ship_cost(1e6) == (0.0, 0.0)
        b = B(rate_bps=1e6, latency_s=0.5, energy_per_bit=1e-9,
              payload_factor=2.0)
        t, e = b.ship_cost(1e6)
        assert t == pytest.approx(0.5 + 2.0)
        assert e == pytest.approx(2e6 * 1e-9)
        assert b.payload_bits(1e6) == 2e6
        assert B(codec="int8").wire_factor == 0.5
        assert B(codec="int8", payload_factor=3.0).wire_factor == 3.0
        assert B(rate_bps=1e6, codec="bf16",
                 latency_s=0.0).ship_cost(1e6)[0] == pytest.approx(1.0)
    for kw in (dict(codec="int8", payload_factor=1.25, rate_bps=3e7,
                    latency_s=0.02, energy_per_bit=2e-9),
               dict(codec="bf16"), dict()):
        jb, tb = jtopo.BackhaulConfig(**kw), topology.BackhaulConfig(**kw)
        assert dataclasses.asdict(jb) == dataclasses.asdict(tb)
        assert tb.wire_factor == jb.wire_factor
        assert tb.payload_bits(12345.0) == jb.payload_bits(12345.0)
        assert tb.ship_cost(12345.0) == jb.ship_cost(12345.0)
    assert [f.name for f in dataclasses.fields(topology.BackhaulConfig)] \
        == [f.name for f in dataclasses.fields(jtopo.BackhaulConfig)]


@pytest.mark.parametrize("factor", [0.0, -1.0])
def test_backhaul_payload_factor_must_be_positive(factor):
    from repro import topology as jtopo
    from repro_torch import topology
    for mod in (jtopo, topology):
        with pytest.raises(ValueError, match="payload_factor must be > 0"):
            mod.BackhaulConfig(payload_factor=factor)


def test_edge_aggregator_counts_its_absorbs():
    from repro.topology import edge as jedge
    from repro_torch.topology import edge
    tree = _np_tree(4, jnp.float32)
    jt, tt = _both(tree, jnp.float32)
    jmask = jax.tree.map(jnp.ones_like, jt)
    tmask = pytree.tree_map(torch.ones_like, tt)
    je, te = jedge.EdgeAggregator(0, jt), edge.EdgeAggregator(0, tt)
    assert te.n_absorbed == je.n_absorbed == 0
    for w in (1.0, 2.0, 0.5):
        je.absorb(jt, jmask, w)
        te.absorb(tt, tmask, w)
    assert te.n_absorbed == je.n_absorbed == 3


def test_set_fleet_size_on_both_telemetry_classes():
    """The live session hands the fleet size to its registry (rollup
    engages at the threshold) and records nothing; the null session
    ignores it."""
    from repro import telemetry as jtel
    from repro_torch import telemetry
    for mod in (jtel, telemetry):
        tel = mod.Telemetry(rollup=mod.RollupPolicy(device_threshold=8))
        tel.set_fleet_size(7)
        assert tel.registry.fleet_size == 7 and not tel.registry.rollup_active
        tel.set_fleet_size(8)
        assert tel.registry.fleet_size == 8 and tel.registry.rollup_active
        assert tel.registry.names() == [] and len(tel.sink) == 0
        assert mod.NULL_TELEMETRY.set_fleet_size(8) is None


@pytest.mark.parametrize("padding", ["SAME", "VALID", ((1, 2), (0, 1)),
                                     ((2, 2), (1, 1))],
                         ids=["same", "valid", "asym", "sym"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("size", [9, 10], ids=["odd", "even"])
def test_conv2d_stride_and_padding_match_the_reference(size, stride,
                                                       padding):
    """The port's conv takes a (B, C, H, W) view; the reference NHWC."""
    from repro.models import cnn as jcnn
    from repro_torch.models import cnn
    rng = np.random.default_rng(size * 10 + stride)
    x = rng.standard_normal((2, size, size + 3, 3)).astype(np.float32)
    for k in (5, 4):
        p = {"w": rng.standard_normal((k, k, 3, 6)).astype(np.float32),
             "b": rng.standard_normal(6).astype(np.float32)}
        want = np.asarray(jcnn.conv2d(
            {n: jnp.asarray(v) for n, v in p.items()}, jnp.asarray(x),
            stride=stride, padding=padding))
        got = cnn.conv2d({n: torch.tensor(v) for n, v in p.items()},
                         torch.tensor(x).permute(0, 3, 1, 2),
                         stride=stride, padding=padding)
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_conv2d_default_keeps_its_one_op(monkeypatch):
    """Stride 1, SAME, an odd kernel: one ``F.conv2d`` with its symmetric
    pad, no ``F.pad`` (the model's own calls)."""
    from repro_torch.models import cnn
    calls = []
    conv = cnn.F.conv2d

    def record(*args, **kw):
        calls.append((kw["stride"], kw["padding"]))
        return conv(*args, **kw)

    def no_pad(*args, **kw):
        raise AssertionError("F.pad on the stride-1 SAME path")
    monkeypatch.setattr(cnn.F, "conv2d", record)
    monkeypatch.setattr(cnn.F, "pad", no_pad)
    cnn.conv2d({"w": torch.ones(5, 5, 2, 3), "b": torch.zeros(3)},
               torch.ones(1, 2, 7, 7))
    assert calls == [(1, (2, 2))]


@pytest.mark.parametrize("kw", [dict(out_dir=None),
                                dict(out_dir="x", enabled=False)],
                         ids=["no-dir", "disabled"])
def test_profile_trace_disabled_yields_none(tmp_path, kw):
    from repro_torch.telemetry import profile_trace
    if kw["out_dir"] is not None:
        kw = dict(kw, out_dir=str(tmp_path / kw["out_dir"]))
    with profile_trace(**kw) as prof_dir:
        assert prof_dir is None
        assert torch.autograd.profiler._is_profiler_enabled is False
    assert list(tmp_path.iterdir()) == []
