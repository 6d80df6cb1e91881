"""The port's Table I baselines, aggregation weights and learning gains
against the JAX package's, on the same numpy inputs.

The compressors run on a small update pytree (with ties and zeros at the
top-k threshold), the reference drawing its uniforms from a key and the
port taking the same draw (``jax.random.uniform(key, (N,))``; UVeQFed's
dither is that draw minus 0.5).  The resource policies run over device
environments from the reference's fleet draws, chosen to reach FedHQ's
level counts at both clips (2 and 65536).

Tolerances: masks, level indices, strategies, level counts and weights
exact; values rtol 1e-6 and bits rtol 1e-5 (float32 sums in another
order); gains exact.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.core import gains as jgains  # noqa: E402
from repro.orchestrator import policies as jpolicies  # noqa: E402
from repro.sysmodel import population as jpop  # noqa: E402
from repro.train import baselines as jbase  # noqa: E402
from repro.utils.pytree import flatten_to_vector  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import gains, schedule  # noqa: E402
from repro_torch.orchestrator import policies  # noqa: E402
from repro_torch.train import baselines  # noqa: E402
from repro_torch.train.fl_loop import METHODS  # noqa: E402

torch.set_num_threads(1)

BASELINES = METHODS[1:]
SHAPES = {"conv": {"w": (3, 3, 2, 8), "b": (8,)},
          "dense": {"w": (40, 10), "b": (10,)}}


def _update(seed, ties=False):
    rng = np.random.default_rng(seed)

    def draw(shape):
        x = rng.standard_normal(shape).astype(np.float32) * 1e-2
        # a coarse grid puts many equal magnitudes (and zeros) at the
        # top-k threshold
        return np.round(x, 2) if ties else x

    return {k: {n: draw(s) for n, s in v.items()} for k, v in SHAPES.items()}


def _both(tree_np, seed):
    """(jax tree, port tree, key, the port's uniforms from that key)."""
    key = jax.random.PRNGKey(seed)
    n = sum(int(np.prod(s)) for v in SHAPES.values() for s in v.values())
    rand = torch.tensor(np.array(jax.random.uniform(key, (n,))))
    return (jax.tree.map(jnp.asarray, tree_np),
            bridge.params_from_numpy(tree_np, "cpu"), key, rand)


def _flat_j(tree):
    return np.asarray(flatten_to_vector(tree)[0])


def _flat_t(tree):
    return _flat_j(bridge.params_to_numpy(tree))


def _check(jc, tc):
    np.testing.assert_array_equal(_flat_t(tc.mask), _flat_j(jc.mask))
    np.testing.assert_allclose(_flat_t(tc.values), _flat_j(jc.values),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(tc.bits), float(jc.bits), rtol=1e-5)


CASES = [(seed, ties) for seed in (0, 1) for ties in (False, True)]


@pytest.mark.parametrize("seed,ties", CASES)
@pytest.mark.parametrize("keep_frac", [1.0 / 16.0, 0.3])
def test_top_k_compressors_match(seed, ties, keep_frac):
    jt, tt, key, rand = _both(_update(seed, ties), seed)
    _check(jbase.stc_compress(jt, keep_frac, key),
           baselines.stc_compress(tt, keep_frac))
    _check(jbase.qsgd_compress(jt, keep_frac, 16, key),
           baselines.qsgd_compress(tt, keep_frac, 16, rand))
    _check(jbase.uveqfed_compress(jt, keep_frac, 16, key),
           baselines.uveqfed_compress(tt, keep_frac, 16, rand))


@pytest.mark.parametrize("seed,ties", CASES)
@pytest.mark.parametrize("n_levels", [2, 16, 181, 65536])
def test_fedhq_and_identity_compressors_match(seed, ties, n_levels):
    jt, tt, key, rand = _both(_update(seed, ties), seed)
    _check(jbase.fedhq_compress(jt, n_levels, key),
           baselines.fedhq_compress(tt, n_levels, rand))
    policy = baselines.BaselinePolicy("fedavg")
    ident = policy.compress(tt, None, lambda n: pytest.fail("no draw"))
    _check(jbase.BaselinePolicy("fedavg").compress(jt, None, key), ident)
    np.testing.assert_array_equal(_flat_t(ident.values), _flat_j(jt))


@pytest.mark.parametrize("seed,ties", CASES)
@pytest.mark.parametrize("n_levels", [2, 16, 65536])
def test_quantize_step_levels_match_exactly(seed, ties, n_levels):
    """The masked range then one ``prob_quantize`` call (the kernel's
    plain version here) gives the reference's level indices exactly, at
    FedHQ's 65536 levels too (65537 histogram bins)."""
    jt, tt, key, rand = _both(_update(seed, ties), seed)
    jvec = flatten_to_vector(jt)[0]
    tvec = torch.from_numpy(np.asarray(jvec))
    for keep in (1.0, 1.0 / 16.0):
        jmask = jbase._topk_mask(jvec, keep)
        tmask = baselines._topk_mask(tvec, keep)
        np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
        jq = jcomp.prob_quantize(jvec, jmask, n_levels, key)
        tq = baselines._quantize(tvec, tmask, n_levels, rand)
        np.testing.assert_array_equal(tq.levels.numpy(),
                                      np.asarray(jq.levels))
        assert int(tq.levels.max()) <= n_levels
        np.testing.assert_allclose(tq.values.numpy(), np.asarray(jq.values),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(
            float(jcomp.compressed_bits(jq, jmask, n_levels)),
            float(baselines.compression.compressed_bits(tq, tmask,
                                                        n_levels)),
            rtol=1e-5)


def _envs():
    """Reference fleet draws over three model sizes: FedHQ's level count
    reaches both of its clips (2 and 65536) among them."""
    out = []
    for seed, W, S_bits in ((0, 7.4e7, 3.2e4), (1, 7.4e7, 5.3e7),
                            (2, 9.3e8, 1.1e8)):
        rng = np.random.default_rng(seed)
        fleet = jpop.make_fleet(rng, jpop.FleetConfig(n_devices=6),
                                rng.integers(16, 400, size=6))
        out.extend(fleet.round_envs(rng, W, S_bits))
    return out


def _port_env(env):
    return schedule.DeviceEnv(**dataclasses.asdict(env))


def test_envs_reach_both_fedhq_level_clips():
    levels = {jbase.BaselinePolicy("fedhq").fedhq_levels(e) for e in _envs()}
    assert {2, 65536} <= levels and len(levels) > 2


@pytest.mark.parametrize("method", BASELINES)
def test_resource_policies_match_exactly(method):
    jpol, tpol = jbase.BaselinePolicy(method), baselines.BaselinePolicy(
        method)
    for env in _envs():
        tenv = _port_env(env)
        for tier in range(3):
            assert dataclasses.asdict(tpol.strategy(tenv, tier)) == \
                dataclasses.asdict(jpol.strategy(env, tier))
        assert tpol.fedhq_levels(tenv) == jpol.fedhq_levels(env)
        for alpha in (0.25, 0.4, 1.0):
            for beta in (0.003, 0.0859375, 1.0):
                bits = alpha * beta * env.S_bits
                assert baselines.fit_frequency(tenv, alpha, bits) == \
                    jbase.fit_frequency(env, alpha, bits)
                assert dataclasses.asdict(
                    baselines.realized_strategy(tenv, alpha, beta)) == \
                    dataclasses.asdict(jbase.realized_strategy(env, alpha,
                                                               beta))


def _updates():
    rng = np.random.default_rng(5)
    return [types.SimpleNamespace(alpha=a, beta_target=b, n_samples=n)
            for a, b, n in zip((0.25, 0.55, 1.0, 0.85, 0.4),
                               (0.004, 0.0, 0.0667, 1.0, 0.02),
                               rng.integers(8, 200, size=5).tolist())]


@pytest.mark.parametrize("levels", [[2, 16, 65536], [3, 3], [181, 7, 44, 2]])
def test_fedhq_weights_match_exactly(levels):
    got = baselines.fedhq_weights(levels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbase.fedhq_weights(levels)))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("use_aio", [True, False])
def test_aggregation_weights_match_exactly(method, use_aio):
    ups = _updates()
    fedhq_L = [2, 16, 65536, 181, 7] if method == "fedhq" else []
    got = policies.base_weights(method, use_aio, ups, fedhq_L)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(),
        np.asarray(jpolicies.base_weights(method, use_aio, ups, fedhq_L)))
    for i, u in enumerate(ups):
        lvl = fedhq_L[i] if fedhq_L else None
        assert policies.unnormalized_weight(method, use_aio, u, lvl) == \
            jpolicies.unnormalized_weight(method, use_aio, u, lvl)


def test_gains_match_the_reference():
    alphas = [0.25, 0.4, 0.55, 0.7, 0.85, 1.0, 0.3333]
    betas = [0.001, 0.0667, 0.02, 1.0, 0.5, 0.0123, 0.25]
    for a, b in zip(alphas, betas):
        assert float(gains.local_gain(a, b)) == float(jgains.local_gain(a, b))
        for u_sq in (0.0, 1.7, 3.3e4):
            assert float(gains.local_divergence_bound(a, b, u_sq)) == \
                float(jgains.local_divergence_bound(a, b, u_sq))
    np.testing.assert_array_equal(gains.local_gain(alphas, betas).numpy(),
                                  np.asarray(jgains.local_gain(
                                      jnp.asarray(alphas),
                                      jnp.asarray(betas))))
    assert float(gains.global_gain(alphas, betas)) == \
        float(jgains.global_gain(alphas, betas))
    for g_min in (0.0, 0.01, 0.3, 1.0):
        for nu, lam, eps in ((0.1, 1.0, 0.9), (0.5, 2.0, 1.5),
                             (0.3, 1.0, 0.5)):
            kw = dict(nu=nu, lam=lam, eps=eps)
            assert float(gains.contraction_factor(g_min, **kw)) == \
                float(jgains.contraction_factor(g_min, **kw))
            assert gains.rounds_to_epsilon(1e-3, 2.0, g_min, **kw) == \
                jgains.rounds_to_epsilon(1e-3, 2.0, g_min, **kw)
