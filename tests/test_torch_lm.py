"""The port's LM modules against the JAX package's: configs, the bridge,
init, layer primitives, attention, the dense/MoE/VLM decoders and the
transformer shrink spec.

Reduced configs (2 layers, d_model 256, vocab 512), the reference's
parameters carried across with ``repro_torch.bridge`` (biases and norm
scales perturbed with numpy, so that they take part), inputs from a
seeded numpy generator.  ``GQA`` is reduced qwen2-7b with 8 q-heads over
2 kv-heads (head_dim 32), so the head group of the shrink spec exists.

Tolerances: configs, specs, widths, permutations, routing, cache
positions and the bridge's bits exact; layer primitives atol 1e-6;
attention atol 2e-5 (the reference's own, ``tests/test_attention.py``);
float32 logits, caches, MoE outputs and aux losses rtol/atol 1e-5;
init statistics within 5 % of ``1/sqrt(fan_in)`` of one layer.  The
bfloat16 model against the reference's bfloat16 run: logits within
``BF16_ATOL`` (measured 0.0337 of logits up to 4.84 on this CPU, argmax
all equal: a bf16 rounding of the residual stream, moved by a product
summed in another order, carried through two layers).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import shrinking as jshrink  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.core import shrinking  # noqa: E402
from repro_torch.models import attention, moe, transformer as T  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.models.registry import build_model, lm_loss  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

GQA = dict(n_heads=8, n_kv_heads=2, head_dim=32)
BF16_ATOL = 0.05
ALL_ARCHS = sorted(jconfigs._ARCH_MODULES)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw),
            dataclasses.replace(configs.get_config(arch).reduced(), **kw))


def _perturbed(tree, rng):
    """numpy copy of a reference param tree; biases and norm scales (all
    zeros or ones at init) moved by N(0, 0.1) noise."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        a = np.asarray(node)
        if name in ("b", "bias", "scale"):
            a = (a.astype(np.float32)
                 + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return walk(tree, "")


_MODELS = {}


def _model(arch, **kw):
    """(jcfg, cfg, numpy params, jax params, port params), cached."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        jcfg, cfg = _cfgs(arch, **kw)
        raw = jbuild(jcfg).init(jax.random.PRNGKey(0))
        npp = _perturbed(raw, np.random.default_rng(1))
        _MODELS[key] = (jcfg, cfg, npp, jax.tree.map(jnp.asarray, npp),
                        bridge.params_from_numpy(npp, "cpu"))
    return _MODELS[key]


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol)


def _cache_close(tc, jc):
    assert tc["pos"] == int(jc["pos"])
    jb = jc["blocks"]
    np.testing.assert_array_equal(tc["blocks"]["k_pos"].numpy(),
                                  np.asarray(jb["k_pos"]))
    for k in ("k", "v"):
        _close(tc["blocks"][k], jb[k])


# ------------------------------------------------------------------ configs

def _spec_rows(spec):
    return [(g.name, g.size, g.round_to,
             [dataclasses.astuple(e) for e in g.entries],
             dataclasses.astuple(g.sort_by)) for g in spec.groups]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_match_the_reference_field_by_field(arch):
    j, t = jconfigs.get_config(arch), configs.get_config(arch)
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_dtype == getattr(torch, jnp.dtype(jc.dtype).name)
        assert tc.resolved_head_dim == jc.resolved_head_dim
        assert tc.n_params() == jc.n_params()
        assert tc.n_active_params() == jc.n_active_params()


def test_registry_and_input_shapes_match():
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert sorted(configs.INPUT_SHAPES) == sorted(jconfigs.INPUT_SHAPES)
    for name, s in jconfigs.INPUT_SHAPES.items():
        t = configs.get_shape(name)
        assert dataclasses.astuple(t) == dataclasses.astuple(s)
        assert dataclasses.astuple(t.reduced()) == \
            dataclasses.astuple(s.reduced())
    with pytest.raises(KeyError):
        configs.get_config("gpt-5")


def test_bridge_carries_bf16_bit_for_bit_and_keeps_the_router_f32():
    """A bf16 MoE tree as the reference's bf16 init lays it out: every
    leaf bfloat16 but the float32 router."""
    npp = _model("granite-moe-1b-a400m")[2]
    bf16 = np.dtype("bfloat16")          # registered by ml_dtypes (JAX)

    def cast(node, name=""):
        if isinstance(node, dict):
            return {k: cast(v, k if name != "router" else name)
                    for k, v in node.items()}
        return node if name == "router" else node.astype(bf16)

    raw = cast(npp)
    got = bridge.params_from_numpy(raw, "cpu")
    back = bridge.params_to_numpy(got)
    assert got["blocks"]["router"]["w"].dtype == torch.float32
    assert got["blocks"]["experts"]["w_gate"].dtype == torch.bfloat16
    # the port's own bf16 init keeps the router float32 too
    cfg = dataclasses.replace(configs.get_config("granite-moe-1b-a400m")
                              .reduced(), dtype="bfloat16")
    own = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert own["blocks"]["router"]["w"].dtype == torch.float32
    assert own["blocks"]["attn"]["wq"]["w"].dtype == torch.bfloat16
    flat_raw, flat_back = jax.tree.leaves(raw), jax.tree.leaves(back)
    for t, a, b in zip(tree_leaves(got), flat_raw, flat_back):
        assert b.dtype == a.dtype and b.shape == a.shape
        if a.dtype.name == "bfloat16":
            np.testing.assert_array_equal(b.view(np.uint16),
                                          a.view(np.uint16))
            np.testing.assert_array_equal(t.float().numpy(),
                                          a.astype(np.float32))
        else:
            np.testing.assert_array_equal(b, a)


# --------------------------------------------------------------------- init

def test_stacked_init_uses_one_layers_fan_in():
    """Each stacked weight's std is 1/sqrt(fan-in of one layer's leaf),
    not of the (layers, ...) stack; the embedding's is 0.02."""
    cfg = dataclasses.replace(configs.get_config("granite-moe-1b-a400m")
                              .reduced(), n_layers=6)
    p = build_model(cfg).init(torch.Generator().manual_seed(0))
    d, E = cfg.d_model, cfg.moe.n_experts
    want = {("attn", "wq", "w"): d, ("attn", "wo", "w"):
            cfg.n_heads * cfg.resolved_head_dim,
            ("router", "w"): d, ("experts", "w_gate"): E * d,
            ("experts", "w_down"): E * cfg.moe.expert_d_ff}
    for path, fan_in in want.items():
        node = p["blocks"]
        for k in path:
            node = node[k]
        assert node.shape[0] == 6
        std = float(node.float().std())
        assert abs(std * np.sqrt(fan_in) - 1) < 0.05, (path, std)
    assert abs(float(p["embed"]["table"].std()) / 0.02 - 1) < 0.05
    dense = build_model(configs.get_config("qwen2-7b").reduced()).init(
        torch.Generator().manual_seed(1))
    w = dense["blocks"]["mlp"]["w_down"]
    assert abs(float(w.std()) * np.sqrt(w.shape[1]) - 1) < 0.05
    assert torch.equal(dense["blocks"]["attn"]["wq"]["b"],
                       torch.zeros_like(dense["blocks"]["attn"]["wq"]["b"]))


# ---------------------------------------------------------- layer primitives

def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "none"])
def test_norm(kind):
    x = _x((2, 5, 32))
    p = {"scale": _x((32,), 1) + 1, "bias": _x((32,), 2)}
    if kind != "layernorm":
        del p["bias"]
    want = jL.norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x), kind=kind)
    got = L.norm(bridge.params_from_numpy(p, "cpu"), torch.tensor(x),
                 kind=kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope(theta):
    x = _x((2, 40, 4, 32))
    pos = np.broadcast_to(np.arange(40, dtype=np.int32) * 7, (2, 40))
    want = jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos.copy()), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ["swiglu", "silu", "geglu", "gelu", "relu"])
def test_act_and_mlp(name):
    x = _x((3, 7, 16), scale=3.0)
    np.testing.assert_allclose(L._act(name, torch.tensor(x)).numpy(),
                               np.asarray(jL._act(name, jnp.asarray(x))),
                               atol=1e-6)
    p = jax.tree.map(np.asarray, jL.init_mlp(jax.random.PRNGKey(0), 16, 24,
                                             activation=name))
    x = x / 3.0                          # unit scale: outputs of order 1
    want = jL.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                  activation=name)
    got = L.mlp(bridge.params_from_numpy(p, "cpu"), torch.tensor(x),
                activation=name)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


# ---------------------------------------------------------------- attention

def _qkv(B, S, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32)
                 for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


_DENSE = {}


def _jax_dense(H, KV, window, S=256):
    key = (H, KV, window, S)
    if key not in _DENSE:
        q, k, v = _qkv(2, S, H, KV, 16)
        pos = jnp.arange(S)
        _DENSE[key] = (q, k, v, np.asarray(jattn.attention_dense(
            *map(jnp.asarray, (q, k, v)), pos, pos, causal=True,
            window=window)))
    return _DENSE[key]


@pytest.mark.parametrize("H,KV", [(4, 4), (8, 2), (4, 1)])
@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("causal_skip", [False, True])
def test_dense_and_blockwise_attention(H, KV, window, causal_skip):
    q, k, v, want = _jax_dense(H, KV, window)
    pos = torch.arange(256)
    tq, tk, tv = map(torch.tensor, (q, k, v))
    dense = attention.attention_dense(tq, tk, tv, pos, pos, window=window)
    np.testing.assert_allclose(dense.numpy(), want, atol=2e-5)
    out = attention.attention_blockwise(tq, tk, tv, pos, pos, window=window,
                                        block_q=64, block_kv=64,
                                        causal_skip=causal_skip)
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)


def test_blockwise_non_square_blocks_and_bf16():
    q, k, v = _qkv(1, 192, 2, 2, 8)
    pos = jnp.arange(192)
    want = jattn.attention_blockwise(*map(jnp.asarray, (q, k, v)), pos, pos,
                                     block_q=96, block_kv=64)
    tpos = torch.arange(192)
    got = attention.attention_blockwise(*map(torch.tensor, (q, k, v)), tpos,
                                        tpos, block_q=96, block_kv=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    bf = [torch.tensor(a).to(torch.bfloat16) for a in (q, k, v)]
    out = attention.attention_blockwise(*bf, tpos, tpos, block_q=32,
                                        block_kv=32)
    ref = attention.attention_dense(*bf, tpos, tpos)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               atol=3e-2)


@pytest.mark.parametrize("window", [None, 9])
def test_decode_attention(window):
    q, k, v = _qkv(2, 33, 4, 2, 16, seed=5)
    kpos = np.arange(33, dtype=np.int32)
    kpos[-4:] = -1                                  # empty slots
    qpos = np.array([28], np.int32)
    want = jattn.attention_decode(jnp.asarray(q[:, -1:]), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(qpos),
                                  jnp.asarray(kpos), window=window)
    got = attention.attention_decode(
        torch.tensor(q[:, -1:]), torch.tensor(k), torch.tensor(v),
        torch.tensor(qpos), torch.tensor(kpos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_attend_dispatches_dense_then_blockwise(monkeypatch):
    q, k, v, want = _jax_dense(8, 2, None)
    pos = torch.arange(256)
    seen = []
    real = attention.attention_blockwise
    monkeypatch.setattr(attention, "attention_blockwise",
                        lambda *a, **kw: seen.append(kw) or real(*a, **kw))
    tq, tk, tv = map(torch.tensor, (q, k, v))
    dense = attention.attend(tq, tk, tv, pos, pos, blockwise_threshold=256)
    assert not seen
    blk = attention.attend(tq, tk, tv, pos, pos, blockwise_threshold=128,
                           causal_skip=True)
    assert seen == [dict(causal=True, window=None, causal_skip=True)]
    for out in (dense, blk):
        np.testing.assert_allclose(out.numpy(), want, atol=2e-5)


# ------------------------------------------------------------ model outputs

_TOKS = np.random.default_rng(7).integers(0, 512, (2, 10)).astype(np.int32)


@pytest.mark.parametrize("arch,kw", [("qwen2-7b", {}), ("phi3-mini-3.8b", {}),
                                     ("qwen2-7b", GQA)])
def test_forward_prefill_and_decode_match(arch, kw):
    jcfg, cfg, _, jp, tp = _model(arch, **kw)
    toks = _TOKS % cfg.vocab_size
    jfwd = jax.jit(JT.forward_lm, static_argnums=2)
    _close(T.forward_lm(tp, torch.tensor(toks), cfg),
           jfwd(jp, jnp.asarray(toks), jcfg))
    jlog, jc = jax.jit(JT.prefill_lm, static_argnums=(2, 3))(
        jp, jnp.asarray(toks), jcfg, 14)
    tlog, tc = T.prefill_lm(tp, torch.tensor(toks), cfg, 14)
    _close(tlog, jlog)
    _cache_close(tc, jc)
    jdec = jax.jit(JT.decode_lm, static_argnums=3)
    for _ in range(3):
        tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
        jlog, jc = jdec(jp, jc, jnp.asarray(tok), jcfg)
        tlog, tc = T.decode_lm(tp, tc, torch.tensor(tok), cfg)
        _close(tlog, jlog)
        _cache_close(tc, jc)


def test_lm_loss_matches():
    from repro.models.registry import lm_loss as jlm_loss
    logits = _x((2, 6, 50), 3, scale=3.0)
    toks = np.random.default_rng(4).integers(0, 50, (2, 6)).astype(np.int32)
    np.testing.assert_allclose(
        float(lm_loss(torch.tensor(logits), torch.tensor(toks))),
        float(jlm_loss(jnp.asarray(logits), jnp.asarray(toks))), rtol=1e-6)


def test_sliding_window_prefill_cache_is_the_ring():
    jcfg, cfg, _, jp, tp = _model("qwen2-7b")
    jcfg = dataclasses.replace(jcfg, sliding_window=8)
    cfg = dataclasses.replace(cfg, sliding_window=8)
    toks = np.random.default_rng(2).integers(0, 512, (1, 12)).astype(
        np.int32)
    jlog, jc = jax.jit(JT.prefill_lm, static_argnums=(2, 3))(
        jp, jnp.asarray(toks), jcfg, 20)
    tlog, tc = T.prefill_lm(tp, torch.tensor(toks), cfg, 20)
    _close(tlog, jlog)
    _cache_close(tc, jc)
    assert tc["blocks"]["k_pos"][0].tolist() == [8, 9, 10, 11, 4, 5, 6, 7]
    # the decode loop over the same prompt fills the same ring
    lc = T.init_lm_cache(cfg, 1, 20, "cpu")
    for t in range(12):
        ll, lc = T.decode_lm(tp, lc, torch.tensor(toks[:, t:t + 1]), cfg)
    assert torch.equal(lc["blocks"]["k_pos"], tc["blocks"]["k_pos"])
    _close(ll[:, 0], tlog[:, -1], atol=1e-4, rtol=1e-4)
    for k in ("k", "v"):
        _close(lc["blocks"][k], tc["blocks"][k], atol=1e-5)


def _moe_cfgs(capacity_factor, moe_decode="dispatch"):
    jcfg, cfg, npp, jp, tp = _model("granite-moe-1b-a400m")
    rep = dict(moe=dataclasses.replace(cfg.moe,
                                       capacity_factor=capacity_factor),
               moe_decode=moe_decode)
    jrep = dict(rep, moe=dataclasses.replace(jcfg.moe,
                                             capacity_factor=capacity_factor))
    return (dataclasses.replace(jcfg, **jrep), dataclasses.replace(cfg, **rep),
            jax.tree.map(lambda a: a[0], jp["blocks"]),
            T.layer(tp["blocks"], 0))


def _drops(p, x, cfg):
    """(token, k) assignments past their expert's capacity."""
    _, idx, _ = moe._route(p["router"], x, cfg)
    onehot = torch.nn.functional.one_hot(idx, cfg.moe.n_experts).float()
    pos = moe.capacity_slots(onehot)
    return int(((pos >= moe.capacity(cfg, x.shape[1])) * onehot).sum())


@pytest.mark.parametrize("capacity_factor,dropped", [(1.25, True),
                                                     (16.0, False)])
def test_moe_mlp_matches_with_and_without_drops(capacity_factor, dropped):
    jcfg, cfg, jp, tp = _moe_cfgs(capacity_factor)
    # a direction shared by every token skews the routing, so that some
    # experts overflow at the default capacity
    x = _x((2, 32, cfg.d_model), 8) + 2 * _x((cfg.d_model,), 12)
    jy, jaux = jax.jit(jmoe.moe_mlp, static_argnums=2)(jp, jnp.asarray(x),
                                                       jcfg)
    ty, taux = moe.moe_mlp(tp, torch.tensor(x), cfg)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert (_drops(tp, torch.tensor(x), cfg) > 0) == dropped
    jw, jidx, _ = jmoe._route(jp["router"], jnp.asarray(x), jcfg)
    tw, tidx, _ = moe._route(tp["router"], torch.tensor(x), cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("moe_decode", ["dispatch", "gather"])
def test_moe_decode_block_matches(moe_decode):
    jcfg, cfg, jp, tp = _moe_cfgs(1.25, moe_decode)
    x = _x((2, 1, cfg.d_model), 9)
    jc = JT.init_block_cache(jcfg, 2, 6)
    tc = T.init_block_cache(cfg, 2, 6, "cpu")
    jdec = jax.jit(jmoe.decode_block, static_argnums=4)
    for pos in range(3):
        jx, jc = jdec(jp, jnp.asarray(x), jc, pos, jcfg)
        tx = moe.decode_block(tp, torch.tensor(x), tc, pos, cfg)
        _close(tx, jx)
        np.testing.assert_array_equal(tc["k_pos"].numpy(),
                                      np.asarray(jc["k_pos"]))
        _close(tc["k"], jc["k"])
        x = np.asarray(jx)


def test_moe_model_prefill_and_decode_match():
    jcfg, cfg, _, jp, tp = _model("granite-moe-1b-a400m")
    toks = np.random.default_rng(3).integers(0, 512, (2, 16)).astype(
        np.int32)
    jlog, jc = jax.jit(JT.prefill_lm, static_argnums=(2, 3))(
        jp, jnp.asarray(toks), jcfg, 18)
    tlog, tc = T.prefill_lm(tp, torch.tensor(toks), cfg, 18)
    _close(tlog, jlog)
    _cache_close(tc, jc)
    tok = np.asarray(jnp.argmax(jlog[:, -1:], -1)).astype(np.int32)
    jlog, jc = jax.jit(JT.decode_lm, static_argnums=3)(
        jp, jc, jnp.asarray(tok), jcfg)
    tlog, tc = T.decode_lm(tp, tc, torch.tensor(tok), cfg)
    _close(tlog, jlog)
    _cache_close(tc, jc)


def test_forward_vlm_matches():
    jcfg, cfg, _, jp, tp = _model("pixtral-12b")
    patches = _x((2, cfg.vlm.n_patches, cfg.vlm.patch_embed_dim), 11)
    toks = np.random.default_rng(5).integers(0, 512, (2, 24)).astype(
        np.int32)
    want = jax.jit(jvlm.forward_vlm, static_argnums=3)(
        jp, jnp.asarray(toks), jnp.asarray(patches), jcfg)
    got = vlm.forward_vlm(tp, torch.tensor(toks), torch.tensor(patches), cfg)
    _close(got, want)
    model = build_model(cfg)
    _close(model.forward(tp, {"tokens": torch.tensor(toks),
                              "patch_embeds": torch.tensor(patches)}), want)


def test_unported_families_raise():
    """Every family builds, serves a decode step and has a forward; what
    still raises: the batched prefill of the recurrent families (the
    reference asserts; they prefill through the decode loop) and an FL
    simulation on an LM arch (its trainer is the pod path's)."""
    from repro_torch.orchestrator import runner
    from repro_torch.train.fl_loop import FLRunConfig
    for arch in ("falcon-mamba-7b", "recurrentgemma-9b",
                 "seamless-m4t-large-v2"):
        cfg = configs.get_config(arch).reduced()
        model = build_model(cfg)
        p = model.init(torch.Generator().manual_seed(0))
        cache = model.init_cache(1, 4, "cpu")
        logits, cache = model.decode(p, cache, {"tokens": torch.zeros(
            (1, 1), dtype=torch.int32)})
        assert logits.shape == (1, 1, cfg.vocab_size) and cache["pos"] == 1
        if cfg.family != "encdec":
            with pytest.raises(ValueError, match="decode"):
                T.prefill_lm(p, torch.zeros((1, 4), dtype=torch.int32), cfg,
                             4)
    with pytest.raises(NotImplementedError, match="Pod path"):
        runner.Simulation(FLRunConfig(arch="falcon-mamba-7b"), device="cpu")


@pytest.mark.parametrize("arch", sorted(configs.ASSIGNED_ARCHS))
def test_flops_per_sample_matches(arch):
    from repro.train.fl_loop import flops_per_sample as jflops
    from repro_torch.train.fl_loop import flops_per_sample
    got = flops_per_sample(configs.get_config(arch))
    assert got == jflops(jconfigs.get_config(arch))
    if arch == "qwen2-7b":
        assert got == 45692903424.0
    if arch == "granite-moe-1b-a400m":
        assert got == 2873954304.0


def test_bf16_model_against_the_reference_bf16_run():
    jcfg, cfg = _cfgs("qwen2-7b", dtype="bfloat16")
    raw = jbuild(jcfg).init(jax.random.PRNGKey(0))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, raw), "cpu")
    toks = _TOKS % cfg.vocab_size
    want = np.asarray(jax.jit(JT.forward_lm, static_argnums=2)(
        raw, jnp.asarray(toks), jcfg))
    got = T.forward_lm(tp, torch.tensor(toks), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=BF16_ATOL, rtol=0)


# ------------------------------------------------------------- shrink spec

def _full_template(arch):
    """Nested dict of the full config's leaf shapes (no storage)."""
    jcfg = jconfigs.get_config(arch)
    return jax.tree.map(lambda s: np.empty(0), jbuild(jcfg)
                        .abstract_params()), jcfg


@pytest.mark.parametrize("arch,kw", [("qwen2-7b", {}), ("qwen2-7b", GQA),
                                     ("granite-moe-1b-a400m", {}),
                                     ("pixtral-12b", {}),
                                     ("qwen2-7b-full", {})])
def test_transformer_shrink_spec_matches(arch, kw):
    if arch.endswith("-full"):
        tmpl, jcfg = _full_template("qwen2-7b")
        cfg = configs.get_config("qwen2-7b")
    else:
        jcfg, cfg, npp, _, _ = _model(arch, **kw)
        tmpl = npp
    jspec = jshrink.transformer_shrink_spec(jcfg, tmpl)
    spec = shrinking.transformer_shrink_spec(cfg, tmpl)
    assert _spec_rows(spec) == _spec_rows(jspec)
    for alpha in (1.0, 0.5, 0.25):
        assert spec.widths(alpha) == jspec.widths(alpha)
        assert dataclasses.asdict(shrinking.shrunk_config(cfg, alpha, spec)) \
            == dataclasses.asdict(jshrink.shrunk_config(jcfg, alpha, jspec))
    if arch.endswith("-full"):
        assert spec.widths(0.5) == {"mlp": 13396, "heads": 5}
        assert shrinking.shrunk_config(cfg, 0.5, spec).n_heads == 20


def test_mamba_group_of_the_spec_matches():
    jcfg = jconfigs.get_config("falcon-mamba-7b")
    tmpl = {"blocks": {"in_x": {}}}
    jspec = jshrink.transformer_shrink_spec(jcfg, tmpl)
    spec = shrinking.transformer_shrink_spec(
        configs.get_config("falcon-mamba-7b"), tmpl)
    assert _spec_rows(spec) == _spec_rows(jspec)
    assert [g.name for g in spec.groups] == ["d_inner"]


@pytest.mark.parametrize("alpha", [0.5, 0.25])
def test_sort_shrink_forward_matches_on_grouped_heads(alpha):
    jcfg, cfg, _, jp, tp = _model("qwen2-7b", **GQA)
    jspec = jshrink.transformer_shrink_spec(jcfg, jp)
    spec = shrinking.transformer_shrink_spec(cfg, tp)
    assert [g.name for g in spec.groups] == ["mlp", "heads"]
    jsorted, jperms = jshrink.sort_channels(jp, jspec, return_perms=True)
    tsorted, perms = shrinking.sort_channels(tp, spec, return_perms=True)
    for a, b in zip(perms, jperms):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    toks = _TOKS % cfg.vocab_size
    # sorting preserves the function
    _close(T.forward_lm(tsorted, torch.tensor(toks), cfg),
           T.forward_lm(tp, torch.tensor(toks), cfg), atol=1e-4, rtol=1e-4)
    jsub = jshrink.shrink(jsorted, alpha, jspec)
    sub = shrinking.shrink(tsorted, alpha, spec)
    jscfg = jshrink.shrunk_config(jcfg, alpha, jspec)
    scfg = shrinking.shrunk_config(cfg, alpha, spec)
    assert scfg.n_heads == 2 * spec.widths(alpha)["heads"] < cfg.n_heads
    for a, b in zip(tree_leaves(sub), jax.tree.leaves(jsub)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _close(T.forward_lm(sub, torch.tensor(toks), scfg),
           jax.jit(JT.forward_lm, static_argnums=2)(jsub, jnp.asarray(toks),
                                                    jscfg))
