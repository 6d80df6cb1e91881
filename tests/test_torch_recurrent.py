"""The port's recurrent LM families against the JAX package's: the
Mamba-1 block (falcon-mamba-7b), the RG-LRU block and the hybrid
superblock stack (recurrentgemma-9b), and their serving path.

Reduced configs at float32, the reference's parameters carried across
with ``repro_torch.bridge`` (biases, norm scales and conv biases moved by
numpy noise so that they take part), inputs from a seeded numpy
generator.  Where depth or length could hide a path, the shapes are
chosen to reach it: the SSM runs S=256, two scan chunks; the hybrid runs
``n_layers=5`` (one superblock and a two-layer tail; the reduced
config's 3 layers have no tail) with an 80-token prompt, longer than the
reduced attention window of 64, so its ring cache wraps; ``n_layers=2``
has an empty superblock stack, as the reference allows.

Tolerances: rtol/atol 1e-4 for every float32 comparison (the port's
doubling scan combines in another tree order than the reference's
``lax.associative_scan``, so the two agree within rounding, not bit for
bit; the largest difference read on this CPU was 9.8e-6, recurrentgemma's
logits up to 4.3); the causal conv (the same taps in the same order) rtol/atol 1e-6;
cache positions, sub-model widths and configs exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import shrinking as jshrink  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import rglru, ssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
#: family cases: (arch, config overrides, prompt length)
FAMILIES = {"falcon-mamba": ("falcon-mamba-7b", {}, 256),
            "recurrentgemma-n5": ("recurrentgemma-9b", dict(n_layers=5), 80),
            "recurrentgemma-n2": ("recurrentgemma-9b", dict(n_layers=2),
                                  16)}
_PERTURB = ("b", "bias", "scale", "conv_b", "b_a", "b_x")


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or TOL))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def _perturbed(tree, rng):
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in _PERTURB:
            a = (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(tree, "")


_MODELS = {}


def _model(arch, **kw):
    """(jcfg, cfg, jax params, port params), cached."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw)
        cfg = dataclasses.replace(configs.get_config(arch).reduced(), **kw)
        npp = _perturbed(jbuild(jcfg).init(jax.random.PRNGKey(0)),
                         np.random.default_rng(1))
        _MODELS[key] = (jcfg, cfg, jax.tree.map(jnp.asarray, npp),
                        bridge.params_from_numpy(npp, "cpu"))
    return _MODELS[key]


def _block(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _cache_close(tc, jc):
    """Caches leaf by leaf: positions exact, states at the tolerance."""
    assert tc["pos"] == int(jc["pos"])
    tleaves = sorted(_leaves(tc))
    jleaves = sorted(_leaves(jc))
    assert [k for k, _ in tleaves] == [k for k, _ in jleaves]
    for (k, t), (_, j) in zip(tleaves, jleaves):
        if k.endswith("k_pos"):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            _close(t, j)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() if k != "pos"
                for kv in _leaves(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


# --------------------------------------------------------------- Mamba-1

@pytest.mark.parametrize("width", [4, 2])
def test_causal_conv_matches(width):
    x, w, b = _x((2, 11, 6), 1), _x((width, 6), 2), _x((6,), 3)
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = ssm._causal_conv(torch.tensor(x), torch.tensor(w), torch.tensor(b))
    _close(got, want, rtol=1e-6, atol=1e-6)


def _scan_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    # decays from ~1 down to underflow, as exp(dt * A) with A to -N gives
    a = np.exp(-rng.uniform(0, 20, shape)).astype(np.float32)
    return a, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("h0_scale", [0.0, 1.0])
def test_ssm_scan_matches_over_two_chunks(h0_scale):
    dA, dBx = _scan_inputs((2, 256, 6, 4), 4)
    h0 = _x((2, 6, 4), 5, scale=h0_scale)
    jseq, jlast = jssm.ssm_scan(jnp.asarray(dA), jnp.asarray(dBx),
                                jnp.asarray(h0))
    seq, last = ssm.ssm_scan(torch.tensor(dA), torch.tensor(dBx),
                             torch.tensor(h0))
    _close(seq, jseq)
    _close(last, jlast)
    # and the plain sequential recurrence
    h = torch.tensor(h0)
    want = []
    for t in range(256):
        h = torch.tensor(dA[:, t]) * h + torch.tensor(dBx[:, t])
        want.append(h)
    _close(seq, torch.stack(want, 1), rtol=1e-5, atol=1e-5)


def test_ssm_scan_keeps_the_chunk_precondition():
    dA, dBx = _scan_inputs((1, 200, 2, 2), 6)
    with pytest.raises(ValueError, match="multiple of the scan chunk"):
        ssm.ssm_scan(torch.tensor(dA), torch.tensor(dBx),
                     torch.zeros((1, 2, 2)))
    # a sequence shorter than a chunk is one chunk, as in the reference
    seq, _ = ssm.ssm_scan(torch.tensor(dA[:, :50]), torch.tensor(dBx[:, :50]),
                          torch.zeros((1, 2, 2)))
    _close(seq, jssm.ssm_scan(jnp.asarray(dA[:, :50]),
                              jnp.asarray(dBx[:, :50]),
                              jnp.zeros((1, 2, 2)))[0])


def test_ssm_elements_and_softplus_match():
    jcfg, cfg, jp, tp = _model("falcon-mamba-7b")
    xh = _x((2, 9, cfg.ssm.d_inner), 7)
    want = jssm._ssm_elements(_block(jp["blocks"]), jnp.asarray(xh), jcfg)
    got = ssm._ssm_elements(T.layer(tp["blocks"], 0), torch.tensor(xh), cfg)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-6)
    x = np.array([-60, -20, -1, 0, 1, 19.9, 20.1, 25, 60], np.float32)
    np.testing.assert_allclose(ssm.softplus(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=0)


def test_ssm_apply_and_decode_block_match():
    jcfg, cfg, jp, tp = _model("falcon-mamba-7b")
    jb, tb = _block(jp["blocks"], 1), T.layer(tp["blocks"], 1)
    x = _x((2, 256, cfg.d_model), 8)
    pos = np.broadcast_to(np.arange(256, dtype=np.int32), (2, 256))
    want = jax.jit(jssm.apply_block, static_argnums=3)(
        jb, jnp.asarray(x), jnp.asarray(pos), jcfg)
    _close(ssm.apply_block(tb, torch.tensor(x), torch.tensor(pos), cfg),
           want)
    jc = jssm.init_block_cache(jcfg, 2, 8)
    tc = ssm.init_block_cache(cfg, 2, 8, "cpu")
    jdec = jax.jit(jssm.decode_block, static_argnums=4)
    for t in range(5):
        xt = x[:, t:t + 1]
        jy, jc = jdec(jb, jnp.asarray(xt), jc, t, jcfg)
        ty = ssm.decode_block(tb, torch.tensor(xt), tc, t, cfg)
        _close(ty, jy)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])


# --------------------------------------------------------------- RG-LRU

def _rg(n_layers=5):
    jcfg, cfg, jp, tp = _model("recurrentgemma-9b", n_layers=n_layers)
    return jcfg, cfg, _block(jp["blocks"])["b0"], \
        T.layer(tp["blocks"], 0)["b0"]


def test_rglru_gates_match():
    _, cfg, jb, tb = _rg()
    x = _x((2, 9, cfg.d_model), 9, scale=2.0)
    for g, w in zip(rglru._rglru_gates(tb, torch.tensor(x)),
                    jrglru._rglru_gates(jb, jnp.asarray(x))):
        _close(g, w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("h0_scale", [0.0, 1.0])
def test_rglru_scan_matches_over_two_chunks(h0_scale):
    a, b = _scan_inputs((2, 256, 5), 10)
    h0 = _x((2, 5), 11, scale=h0_scale)
    jseq, jlast = jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(h0))
    seq, last = rglru.rglru_scan(torch.tensor(a), torch.tensor(b),
                                 torch.tensor(h0))
    _close(seq, jseq)
    _close(last, jlast)


def test_rglru_apply_and_decode_block_match():
    jcfg, cfg, jb, tb = _rg()
    x = _x((2, 128, cfg.d_model), 12)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32), (2, 128))
    want = jax.jit(jrglru.apply_rglru_block, static_argnums=3)(
        jb, jnp.asarray(x), jnp.asarray(pos), jcfg)
    _close(rglru.apply_rglru_block(tb, torch.tensor(x), torch.tensor(pos),
                                   cfg), want)
    jc = jrglru.init_rglru_cache(jcfg, 2)
    tc = rglru.init_rglru_cache(cfg, 2, "cpu")
    jdec = jax.jit(jrglru.decode_rglru_block, static_argnums=4)
    for t in range(5):
        xt = x[:, t:t + 1]
        jy, jc = jdec(jb, jnp.asarray(xt), jc, t, jcfg)
        _close(rglru.decode_rglru_block(tb, torch.tensor(xt), tc, t, cfg),
               jy)
        _close(tc["h"], jc["h"])
        _close(tc["conv"], jc["conv"])


def test_hybrid_layout_matches():
    """Superblocks and tail: the port's tree has the reference's
    structure and leaf shapes, at 5 layers (1 + tail 2) and at 2 (no
    superblock, tail 2)."""
    for n in (5, 2, 3):
        jcfg, cfg, jp, tp = _model("recurrentgemma-9b", n_layers=n)
        mine = T.init_lm(torch.Generator().manual_seed(0), cfg)
        got = sorted((k, tuple(t.shape)) for k, t in _leaves(mine))
        want = sorted((k, tuple(np.shape(a))) for k, a in _leaves(jp))
        assert got == want
        assert T._n_stack(cfg) == JT._n_stack(jcfg)
        assert ("tail" in tp) == (n % 3 != 0)
        jcache = JT.init_lm_cache(jcfg, 2, 70)
        tcache = T.init_lm_cache(cfg, 2, 70, "cpu")
        assert sorted((k, tuple(t.shape)) for k, t in _leaves(tcache)) == \
            sorted((k, tuple(np.shape(a))) for k, a in _leaves(jcache))


# ------------------------------------------------------------ LM families

@pytest.mark.parametrize("case", list(FAMILIES))
def test_family_forward_prefill_and_decode_match(case):
    """``build_model(...).forward``; the decode-loop prefill (logits and
    every cache leaf); then 8 decode steps teacher-forced with the
    reference's greedy tokens.  The port's forward also agrees with its
    own decode loop in the last position."""
    arch, kw, S = FAMILIES[case]
    jcfg, cfg, jp, tp = _model(arch, **kw)
    jmodel, model = jbuild(jcfg), build_model(cfg)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (2, S))
    toks = toks.astype(np.int32)
    want = np.asarray(jax.jit(jmodel.forward)(
        jp, {"tokens": jnp.asarray(toks)}))
    got = model.forward(tp, {"tokens": torch.tensor(toks)})
    _close(got, want)
    n_dec = 8
    jlog, jc = jserve.prefill_into_cache(jmodel, jp, jnp.asarray(toks),
                                         S + n_dec)
    tlog, tc = serve.prefill_into_cache(model, tp, torch.tensor(toks),
                                        S + n_dec)
    _close(tlog, jlog)
    _close(tlog[:, 0], got[:, -1])
    _cache_close(tc, jc)
    jstep = jax.jit(jmodel.decode)
    for _ in range(n_dec):
        feed = np.asarray(jlog[:, -1]).argmax(-1)[:, None].astype(np.int32)
        jlog, jc = jstep(jp, jc, {"tokens": jnp.asarray(feed)})
        tlog, tc = model.decode(tp, tc, {"tokens": torch.tensor(feed)})
        _close(tlog, jlog)
    _cache_close(tc, jc)
    assert tc["pos"] == S + n_dec
    if case == "recurrentgemma-n5":
        # the attention block's ring of 64 slots wrapped
        k_pos = tc["blocks"]["b2"]["k_pos"][0]
        assert int(k_pos.min()) == S + n_dec - 64


def test_falcon_mamba_alpha_half_submodel_matches():
    jcfg, cfg, jp, tp = _model("falcon-mamba-7b")
    jspec = jshrink.transformer_shrink_spec(jcfg, jp)
    jsub = jshrink.shrink(jshrink.sort_channels(jp, jspec), 0.5, jspec)
    jscfg = jshrink.shrunk_config(jcfg, 0.5, jspec)
    scfg, sub, widths = serve.submodel(cfg, tp, 0.5)
    assert widths == jspec.widths(0.5) == {"d_inner": 363}
    assert dataclasses.asdict(scfg) == dataclasses.asdict(jscfg)
    for a, b in zip(tree_leaves(sub), jax.tree.leaves(jsub)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 32))
    _close(build_model(scfg).forward(sub, {"tokens": torch.tensor(toks)}),
           jax.jit(jbuild(jscfg).forward)(
               jsub, {"tokens": jnp.asarray(toks, jnp.int32)}))


def test_bridge_carries_the_hybrid_tree_with_its_tail():
    jcfg, cfg, jp, tp = _model("recurrentgemma-9b", n_layers=5)
    back = bridge.params_to_numpy(tp)
    assert sorted(k for k, _ in _leaves(back)) == \
        sorted(k for k, _ in _leaves(jp))
    for (k, a), (_, b) in zip(sorted(_leaves(back)), sorted(_leaves(jp))):
        assert a.dtype == np.asarray(b).dtype, k
        np.testing.assert_array_equal(a, np.asarray(b))
    assert tp["tail"]["conv_w"].shape == (2, 4, cfg.d_model)


@pytest.mark.parametrize("arch,line", [
    ("falcon-mamba-7b", "serving alpha=0.5 sub-model (widths: "
                        "{'d_inner': 363})"),
    ("recurrentgemma-9b", "arch has no shrinkable groups; serving full "
                          "model")])
def test_cli_serves_the_recurrent_archs(arch, line, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--alpha", "0.5",
                "--batch", "2", "--prompt-len", "16", "--decode-tokens",
                "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == line
    assert lines[1].startswith("prefill 16 toks x2: ")
    assert lines[2].startswith("sample: [")
