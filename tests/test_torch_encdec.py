"""The port's encoder-decoder family (seamless-m4t-large-v2) against the
JAX package's: the encoder and decoder blocks, ``encode``,
``forward_encdec``, the cross-attention cache and decode; then the serve
path, the step functions and input specs of the three families this
slice adds, and the serve CLI.

The reduced config at float32 (2 + 2 layers, d_model 256, 32 frames),
the reference's parameters carried across with ``repro_torch.bridge``
(biases and norm scales moved by numpy noise so that they take part),
frames and tokens from a seeded numpy generator.  Tolerances: rtol/atol
1e-4 for every float32 comparison (attention and layer norms sum in
another order; the largest difference read on this CPU was 4.1e-6 in
logits up to 4.0); cache positions, shapes and dtypes exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "seamless-m4t-large-v2"


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **TOL)


def _perturbed(tree, rng):
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in ("b", "bias", "scale"):
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(tree, "")


@pytest.fixture(scope="module")
def model():
    """(jcfg, cfg, jax params, port params)."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = configs.get_config(ARCH).reduced()
    npp = _perturbed(jbuild(jcfg).init(jax.random.PRNGKey(0)),
                     np.random.default_rng(1))
    return (jcfg, cfg, jax.tree.map(jnp.asarray, npp),
            bridge.params_from_numpy(npp, "cpu"))


def _frames(cfg, B=2, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)


def _tokens(cfg, S, B=2, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in sorted(tree.items()) if k != "pos"
                for kv in _leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def _cache_close(tc, jc):
    assert tc["pos"] == int(jc["pos"])
    tl, jl = _leaves(tc), _leaves(jc)
    assert [k for k, _ in tl] == [k for k, _ in jl]
    for (k, t), (_, j) in zip(tl, jl):
        assert tuple(t.shape) == tuple(np.shape(j)), k
        if k.endswith("k_pos"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t, j)


def test_blocks_and_encode_match(model):
    jcfg, cfg, jp, tp = model
    x = _frames(cfg, seed=4)
    pos = np.broadcast_to(np.arange(x.shape[1], dtype=np.int32), x.shape[:2])
    jb = jax.tree.map(lambda a: a[1], jp["enc"])
    _close(encdec.apply_enc_block(T.layer(tp["enc"], 1), torch.tensor(x),
                                  torch.tensor(pos), cfg),
           jencdec.apply_enc_block(jb, jnp.asarray(x), jnp.asarray(pos),
                                   jcfg))
    mem = _frames(cfg, seed=5)
    y = _frames(cfg, seed=6)[:, :7]
    ypos = pos[:, :7]
    jd = jax.tree.map(lambda a: a[0], jp["dec"])
    td = T.layer(tp["dec"], 0)
    _close(encdec.apply_dec_block(td, torch.tensor(y), torch.tensor(ypos),
                                  torch.tensor(mem), cfg),
           jencdec.apply_dec_block(jd, jnp.asarray(y), jnp.asarray(ypos),
                                   jnp.asarray(mem), jcfg))
    for g, w in zip(encdec._cross_kv(td["cross_attn"], torch.tensor(mem),
                                     cfg),
                    jencdec._cross_kv(jd["cross_attn"], jnp.asarray(mem),
                                      jcfg)):
        _close(g, w)
    frames = _frames(cfg)
    _close(encdec.encode(tp, torch.tensor(frames), cfg),
           jax.jit(jencdec.encode, static_argnums=2)(
               jp, jnp.asarray(frames), jcfg))


def test_forward_encdec_matches(model):
    jcfg, cfg, jp, tp = model
    frames, toks = _frames(cfg), _tokens(cfg, 12)
    want = jax.jit(jbuild(jcfg).forward)(
        jp, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    got = build_model(cfg).forward(tp, {"frames": torch.tensor(frames),
                                        "tokens": torch.tensor(toks)})
    assert got.dtype == torch.float32
    _close(got, want)
    _close(encdec.forward_encdec(tp, torch.tensor(frames),
                                 torch.tensor(toks), cfg), want)


def test_prefilled_cross_cache_and_teacher_forced_decode_match(model):
    """``prefill_encdec_cache`` from frames, then 8 decode steps fed the
    prompt's tokens: each step's logits against the reference's and
    against the port's own ``forward_encdec`` at that position; every
    cache leaf against the reference's."""
    jcfg, cfg, jp, tp = model
    S = 8
    frames, toks = _frames(cfg), _tokens(cfg, S, seed=7)
    jc = jax.jit(jencdec.prefill_encdec_cache, static_argnums=(2, 3, 4))(
        jp, jnp.asarray(frames), jcfg, 2, S + 2)
    tc = encdec.prefill_encdec_cache(tp, torch.tensor(frames), cfg, 2, S + 2)
    _cache_close(tc, jc)
    fwd = encdec.forward_encdec(tp, torch.tensor(frames), torch.tensor(toks),
                                cfg)
    jdec = jax.jit(jencdec.decode_encdec, static_argnums=3)
    for t in range(S):
        feed = toks[:, t:t + 1]
        jlog, jc = jdec(jp, jc, jnp.asarray(feed), jcfg)
        tlog, tc = encdec.decode_encdec(tp, tc, torch.tensor(feed), cfg)
        _close(tlog, jlog)
        _close(tlog[:, 0], fwd[:, t])
    _cache_close(tc, jc)
    assert tc["dec"]["self"]["k_pos"][0].tolist() == list(range(S)) + [-1, -1]


def test_zero_memory_serve_prefill_and_decode_match(model):
    """The serve path's decode-loop prefill from ``init_cache``'s zero
    cross-attention K/V, as the reference serves encdec, then 8
    teacher-forced greedy steps; the self-attention cache fills up to
    its last slot, which later steps overwrite."""
    jcfg, cfg, jp, tp = model
    jmodel, tmodel = jbuild(jcfg), build_model(cfg)
    S, n_dec = 16, 8
    toks = _tokens(cfg, S, seed=8)
    jlog, jc = jserve.prefill_into_cache(jmodel, jp, jnp.asarray(toks),
                                         S + n_dec - 2)
    tlog, tc = serve.prefill_into_cache(tmodel, tp, torch.tensor(toks),
                                        S + n_dec - 2)
    _close(tlog, jlog)
    _cache_close(tc, jc)
    jstep = jax.jit(jmodel.decode)
    for _ in range(n_dec):
        feed = np.asarray(jlog[:, -1]).argmax(-1)[:, None].astype(np.int32)
        jlog, jc = jstep(jp, jc, {"tokens": jnp.asarray(feed)})
        tlog, tc = tmodel.decode(tp, tc, {"tokens": torch.tensor(feed)})
        _close(tlog, jlog)
    _cache_close(tc, jc)
    assert not bool(tc["dec"]["cross"]["k"].any())


def test_bridge_carries_the_encdec_stacks(model):
    jcfg, cfg, jp, tp = model
    back = bridge.params_to_numpy(tp)
    got, want = _leaves(back), _leaves(jp)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert a.dtype == np.asarray(b).dtype, k
        np.testing.assert_array_equal(a, np.asarray(b))
    mine = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert [(k, tuple(t.shape)) for k, t in _leaves(mine)] == \
        [(k, tuple(np.shape(a))) for k, a in _leaves(jp)]


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "recurrentgemma-9b",
                                  ARCH])
def test_step_functions_and_input_specs_match(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    for name, shape in configs.INPUT_SHAPES.items():
        got = steps.input_specs(cfg, shape)
        want = jsteps.input_specs(jcfg, jconfigs.get_shape(name))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape)
            assert str(got[k].dtype) == f"torch.{jnp.dtype(v.dtype).name}"
    jcfg, cfg = jcfg.reduced(), cfg.reduced()
    jmodel, model = jbuild(jcfg), build_model(cfg)
    jp = jmodel.init(jax.random.PRNGKey(4))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    batch = {"tokens": _tokens(cfg, 8, seed=9)}
    if cfg.family == "encdec":
        batch["frames"] = _frames(cfg, seed=10)
    want = jax.jit(jsteps.make_prefill_step(jmodel))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = steps.make_prefill_step(model)(
        tp, {k: torch.tensor(v) for k, v in batch.items()})
    _close(got, want)
    jc, tc = jmodel.init_cache(2, 4), model.init_cache(2, 4, "cpu")
    feed = batch["tokens"][:, :1]
    jlog, jc = jax.jit(jsteps.make_serve_step(jmodel))(
        jp, jc, {"tokens": jnp.asarray(feed)})
    tlog, tc = steps.make_serve_step(model)(tp, tc,
                                            {"tokens": torch.tensor(feed)})
    _close(tlog, jlog)
    assert tc["pos"] == 1


def test_cli_serves_seamless(capsys):
    serve.main(["--device", "cpu", "--arch", ARCH, "--alpha", "0.5",
                "--batch", "2", "--prompt-len", "8", "--decode-tokens", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "arch has no shrinkable groups; serving full model"
    assert lines[1].startswith("prefill 8 toks x2: ")
    assert lines[2].startswith("sample: [")
