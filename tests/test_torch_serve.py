"""The port's serving path against the reference's: batched prefill into
the KV cache, greedy decode, the step functions and the serve CLI.

Reduced configs, the reference's parameters carried across with
``repro_torch.bridge``, prompts from a seeded numpy generator.  The
port's decode is teacher-forced with the reference's greedy tokens, so a
near-tie cannot cascade.  Tolerances: logits rtol/atol 1e-5 at every
step; caches the same, cache positions exact; the port's greedy token
equal to the reference's wherever the reference's top-2 gap exceeds
``TIE``; the CLI's ``widths`` line verbatim.
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
from repro.launch import steps as jsteps  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

TIE = 1e-4
GQA = dict(n_heads=8, n_kv_heads=2, head_dim=32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch,kw", [("qwen2-7b", GQA),
                                     ("granite-moe-1b-a400m", {}),
                                     ("pixtral-12b", {})])
def test_serve_prefill_and_decode_match_teacher_forced(arch, kw):
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw)
    cfg = dataclasses.replace(configs.get_config(arch).reduced(), **kw)
    jmodel, model = jbuild(jcfg), build_model(cfg)
    jp = jmodel.init(jax.random.PRNGKey(2))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    B, S, n_dec = 2, 16, 8
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    prompt = prompt.astype(np.int32)
    jlog, jc = jserve.prefill_into_cache(jmodel, jp, jnp.asarray(prompt),
                                         S + n_dec)
    tlog, tc = serve.prefill_into_cache(model, tp, torch.tensor(prompt),
                                        S + n_dec)
    _close(tlog, jlog)
    jstep = jax.jit(jmodel.decode)
    for _ in range(n_dec):
        want = np.asarray(jlog[:, -1], np.float32)
        tok = want.argmax(-1)
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > TIE
        got = tlog[:, -1].argmax(-1).numpy()
        np.testing.assert_array_equal(got[clear], tok[clear])
        feed = tok[:, None].astype(np.int32)
        jlog, jc = jstep(jp, jc, {"tokens": jnp.asarray(feed)})
        tlog, tc = model.decode(tp, tc, {"tokens": torch.tensor(feed)})
        _close(tlog, jlog)
    assert tc["pos"] == int(jc["pos"]) == S + n_dec
    np.testing.assert_array_equal(tc["blocks"]["k_pos"].numpy(),
                                  np.asarray(jc["blocks"]["k_pos"]))
    for k in ("k", "v"):
        _close(tc["blocks"][k], jc["blocks"][k])


def test_step_functions_and_input_specs_match():
    cfg = configs.get_config("pixtral-12b")
    jcfg = jconfigs.get_config("pixtral-12b")
    for name, shape in configs.INPUT_SHAPES.items():
        got = steps.input_specs(cfg, shape)
        want = jsteps.input_specs(jcfg, jconfigs.get_shape(name))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(v.shape)
            assert str(got[k].dtype) == f"torch.{jnp.dtype(v.dtype).name}"
    cfg = configs.get_config("qwen2-7b").reduced()
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0))
    toks = torch.tensor(np.random.default_rng(1).integers(0, 512, (2, 8)))
    logits = steps.make_prefill_step(model)(p, {"tokens": toks})
    np.testing.assert_array_equal(logits.numpy(),
                                  model.forward(p, {"tokens": toks}).numpy())
    cache = model.init_cache(2, 9, "cpu")
    step = steps.make_serve_step(model)
    out, cache = step(p, cache, {"tokens": toks[:, :1]})
    assert out.shape == (2, 1, cfg.vocab_size) and cache["pos"] == 1


@pytest.mark.parametrize("round_to", [1, 8])
def test_submodel_is_the_reference_cut_and_owns_its_leaves(round_to):
    jcfg = dataclasses.replace(jconfigs.get_config("qwen2-7b").reduced(),
                               **GQA)
    cfg = dataclasses.replace(configs.get_config("qwen2-7b").reduced(), **GQA)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(3))
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jspec = jshrink.transformer_shrink_spec(jcfg, jp, round_to=round_to)
    jsub = jshrink.shrink(jshrink.sort_channels(jp, jspec), 0.5, jspec)
    scfg, sub, widths = serve.submodel(cfg, tp, 0.5, round_to=round_to)
    assert widths == jspec.widths(0.5) and "heads" in widths
    assert dataclasses.asdict(scfg) == dataclasses.asdict(
        jshrink.shrunk_config(jcfg, 0.5, jspec))
    for a, b in zip(tree_leaves(sub), jax.tree.leaves(jsub)):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
        # a copy, as the reference's jnp.take makes: no leaf keeps the
        # full model's storage alive
        assert a.is_contiguous()
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()


def _widths_line(arch, alpha):
    jcfg = jconfigs.get_config(arch).reduced()
    spec = jshrink.transformer_shrink_spec(jcfg,
                                           jbuild(jcfg).abstract_params())
    if not spec.groups:
        return "arch has no shrinkable groups; serving full model"
    return (f"serving alpha={alpha} sub-model "
            f"(widths: {spec.widths(alpha)})")


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_cli_prints_the_reference_widths_line(arch, capsys):
    serve.main(["--device", "cpu", "--arch", arch, "--alpha", "0.5",
                "--batch", "2", "--prompt-len", "16", "--decode-tokens",
                "8"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == _widths_line(arch, 0.5)
    assert lines[1].startswith("prefill 16 toks x2: ")
    assert "decode 8 toks: " in lines[1] and lines[1].endswith(" tok/s)")
    assert lines[2].startswith("sample: [")
    if arch == "qwen2-7b":
        assert lines[0] == "serving alpha=0.5 sub-model (widths: " \
                           "{'mlp': 363})"


def test_cli_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "qwen2-7b", "--batch", "1", "--prompt-len",
                    "4", "--decode-tokens", "2"])
