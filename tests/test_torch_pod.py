"""The port's pod trainer against the JAX package's: the train step, its
gradients and ``remat``, ``--mode pod`` on the CPU, and the launcher's
``--lr`` and ``--event-trace-limit``.

Reduced configs (float32), the reference's parameters carried across with
``repro_torch.bridge``, tokens from a seeded numpy generator (B=2, S=32).
Tolerances: the loss atol ``LOSS_ATOL``; each gradient leaf within
``GRAD_RTOL`` of the leaf's largest |g| (measured: at most 4.9e-6, the
hybrid); after one ``sgd`` step each parameter leaf within ``lr *
GRAD_RTOL`` of its largest |g| plus ``PARAM_ATOL`` of its scale (the
reference's jitted step fuses the multiply-add, the port rounds twice).
AdamW's first update is about ``lr * sign(g)``, so a gradient at the
noise level can move an element by 2 lr: the AdamW path is held at the
loss after two steps, atol ``ADAMW_LOSS_ATOL`` (measured: 9.5e-7).
The three ``remat`` policies give the same loss and gradients bit for
bit on the CPU.
"""
import dataclasses
import json
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.registry import build_model as jbuild  # noqa: E402
from repro.models.registry import loss_fn as jloss  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch import bridge, configs  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.train import checkpoint, optimizer  # noqa: E402
from repro_torch.utils.pytree import tree_leaves  # noqa: E402

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
PARAM_ATOL = 1e-6
ADAMW_LOSS_ATOL = 1e-5
B, S = 2, 32
LR = 0.1
#: every assigned arch, and the hybrid at 5 layers: the reduced
#: recurrentgemma has 3, one superblock and no ``tail`` stack
CASES = [(a, {}) for a in configs.ASSIGNED_ARCHS] + [
    ("recurrentgemma-9b", {"n_layers": 5})]
IDS = [a + ("-5-layers" if kw else "") for a, kw in CASES]

_SETUPS = {}


def _setup(arch, kw):
    """(jmodel, model, numpy params, numpy batch), cached per case."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _SETUPS:
        jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), **kw)
        cfg = dataclasses.replace(configs.get_config(arch).reduced(), **kw)
        jm = jbuild(jcfg)
        npp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (B, min(cfg.vlm.n_patches, S), cfg.vlm.patch_embed_dim)
            ).astype(np.float32)
        if cfg.family == "encdec":
            batch["frames"] = rng.standard_normal(
                (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
        _SETUPS[key] = (jm, build_model(cfg), npp, batch)
    return _SETUPS[key]


def _port(npp, batch):
    return (bridge.params_from_numpy(npp, "cpu"),
            {k: torch.tensor(v) for k, v in batch.items()})


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _max_abs(a):
    return float(np.abs(np.asarray(a, np.float32)).max())


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_train_step_matches_the_reference(arch, kw):
    """Loss and gradients against ``jax.value_and_grad`` of the
    reference's ``loss_fn``, then the parameters after one step of each
    package's ``make_train_step`` with ``sgd``, all at ``remat="full"``."""
    jm, model, npp, batch = _setup(arch, kw)
    jstep = jsteps.make_train_step(jm, jopt.sgd(LR), remat="full")

    @jax.jit
    def reference(p, s, b):
        vg = jax.value_and_grad(
            lambda q: jloss(jm, q, b, remat="full"))(p)
        return vg, jstep(p, s, b)

    jp = _jax(npp)
    (jl, jg), (jp2, js2, jl2) = reference(jp, jopt.sgd(LR).init(jp),
                                          _jax(batch))
    tp, tb = _port(npp, batch)
    loss, grads = steps.value_and_grad(model, tp, tb, remat="full")
    assert abs(float(loss) - float(jl)) <= LOSS_ATOL
    gmax = {}
    for (path, g), want in zip(_paths(grads), jax.tree.leaves(jg)):
        gmax[path] = _max_abs(want)
        err = float(np.abs(g.numpy() - np.asarray(want)).max())
        assert err <= GRAD_RTOL * gmax[path], (path, err, gmax[path])
    opt = optimizer.sgd(LR)
    tp2, ts2, loss2 = steps.make_train_step(model, opt, remat="full")(
        tp, opt.init(tp), tb)
    assert tp2 is tp and int(ts2["step"]) == int(js2["step"]) == 1
    assert abs(float(loss2) - float(jl2)) <= LOSS_ATOL
    for (path, p), want in zip(_paths(tp2), jax.tree.leaves(jp2)):
        want = np.asarray(want)
        err = float(np.abs(p.numpy() - want).max())
        bound = LR * GRAD_RTOL * gmax[path] + PARAM_ATOL * _max_abs(want)
        assert err <= bound, (path, err, bound)


def _paths(tree, prefix=""):
    """(path, leaf) in sorted-key order, the order of ``jax.tree.leaves``
    over the reference's dicts."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m"])
def test_adamw_path_matches_the_reference_at_the_loss(arch):
    """Two steps of each package's ``make_train_step`` with the pod
    trainer's ``adamw(3e-3, warmup=10)``; the losses of both steps and
    the loss at the parameters they reach."""
    jm, model, npp, batch = _setup(arch, {})
    jopt_ = jopt.adamw(3e-3, warmup=10)
    jstep = jax.jit(jsteps.make_train_step(jm, jopt_, remat="full"))
    jp, jb = _jax(npp), _jax(batch)
    js = jopt_.init(jp)
    opt = optimizer.adamw(3e-3, warmup=10)
    tp, tb = _port(npp, batch)
    ts = opt.init(tp)
    step = steps.make_train_step(model, opt, remat="full")
    for _ in range(2):
        jp, js, jl = jstep(jp, js, jb)
        tp, ts, loss = step(tp, ts, tb)
        assert abs(float(loss) - float(jl)) <= ADAMW_LOSS_ATOL
    final = float(jloss(jm, jp, jb, remat="none"))
    got = float(steps.value_and_grad(model, tp, tb, remat="none")[0])
    assert abs(got - final) <= ADAMW_LOSS_ATOL
    assert got < float(jl)            # the steps descend
    assert int(ts["step"]) == 2


@pytest.mark.parametrize("arch,kw", CASES, ids=IDS)
def test_remat_policies_give_equal_loss_and_gradients(arch, kw):
    _, model, npp, batch = _setup(arch, kw)
    tp, tb = _port(npp, batch)
    want = steps.value_and_grad(model, tp, tb, remat="none")
    for remat in ("full", "dots"):
        got = steps.value_and_grad(model, tp, tb, remat=remat)
        assert torch.equal(got[0], want[0])
        for a, b in zip(tree_leaves(got[1]), tree_leaves(want[1])):
            assert torch.equal(a, b)


def _saved_bytes_and_backward_products(model, tp, tb, remat):
    """The bytes autograd saves outside the checkpointed blocks during the
    forward, and the matrix products the backward pass runs."""
    from torch.utils._python_dispatch import TorchDispatchMode
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default}
    saved = []

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += func in dots
            return func(*args, **(kwargs or {}))

    leaves = [p.detach().requires_grad_() for p in tree_leaves(tp)]
    from repro_torch.models.registry import loss_fn
    from repro_torch.utils.pytree import tree_unflatten
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(t.numel() * t.element_size()) or t,
            lambda t: t):
        loss = loss_fn(model, tree_unflatten(tp, leaves), tb, remat=remat)
    with Count():
        torch.autograd.grad(loss, leaves)
    return sum(saved), Count.n


def test_remat_policies_recompute_what_they_say():
    """``full`` and ``dots`` keep the blocks' activations out of autograd's
    saved tensors; in the backward pass ``full`` recomputes the blocks'
    matrix products and ``dots`` reuses them, as ``none`` does."""
    _, model, npp, batch = _setup("qwen2-7b", {})
    tp, tb = _port(npp, batch)
    got = {r: _saved_bytes_and_backward_products(model, tp, tb, r)
           for r in ("none", "dots", "full")}
    assert got["full"][0] < got["none"][0]
    assert got["dots"][0] < got["none"][0]
    assert got["dots"][1] == got["none"][1] < got["full"][1]


def test_unknown_remat_and_anycost_sync_raise():
    jm, model, npp, batch = _setup("seamless-m4t-large-v2", {})
    tp, tb = _port(npp, batch)
    with pytest.raises(ValueError, match="offload"):
        model.forward(tp, tb, remat="offload")
    with pytest.raises(ValueError, match="offload"):
        encdec.encode(tp, tb["frames"], model.cfg, remat="offload")
    _, qmodel, qnp, qb = _setup("qwen2-7b", {})
    qp, qtb = _port(qnp, qb)
    with pytest.raises(ValueError, match="offload"):
        T.forward_lm(qp, qtb["tokens"], qmodel.cfg, remat="offload")
    # the anycost step exists now, and needs a mesh, as the reference's
    # asserts (tests/test_torch_distributed.py runs it over two pods)
    with pytest.raises(ValueError, match="needs the mesh"):
        steps.make_train_step(qmodel, optimizer.sgd(0.1),
                              grad_sync="anycost")
    with pytest.raises(ValueError):
        steps.make_train_step(qmodel, optimizer.sgd(0.1), grad_sync="ring")


def test_prefill_step_takes_no_checkpoint(monkeypatch):
    """Serving passes ``remat="none"``: the prefill step never enters
    ``torch.utils.checkpoint``."""
    _, model, npp, batch = _setup("qwen2-7b", {})
    tp, tb = _port(npp, batch)
    want = steps.make_prefill_step(model)(tp, tb)

    def refuse(*a, **k):
        raise AssertionError("checkpoint called on the serve path")

    monkeypatch.setattr(T, "checkpoint", refuse)
    torch.testing.assert_close(steps.make_prefill_step(model)(tp, tb), want,
                               rtol=0, atol=0)
    with pytest.raises(AssertionError, match="serve path"):
        T.forward_lm(tp, tb["tokens"], model.cfg)


# ----------------------------------------------------------------- the CLI

POD_LINE = re.compile(r"^step +\d+ loss \d+\.\d{4} \(\d+\.\ds\)$")


@pytest.mark.parametrize("arch", ["qwen2-7b", "pixtral-12b",
                                  "seamless-m4t-large-v2"])
def test_pod_cli_prints_the_reference_lines_and_checkpoints(arch, tmp_path,
                                                            capsys):
    """A CPU ``--mode pod --reduced`` run: the reference's lines, a
    checkpoint that loads as the trained parameters bit for bit, with the
    entries (paths, shapes, dtypes) that the reference's ``save_checkpoint``
    writes for the reference's parameters of the same config.  (The
    reference's own ``run_pod`` stops at its sharding constraint under
    this JAX, as its dryrun tests do.)"""
    ckpt = tmp_path / "port"
    losses, params = launch_train.main([
        "--mode", "pod", "--device", "cpu", "--arch", arch, "--reduced",
        "--steps", "3", "--batch", "2", "--seq-len", "64", "--checkpoint",
        str(ckpt)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("[train] using the pod-mode default lr 0.003 "
                        "(pass --lr to override)")
    assert all(POD_LINE.match(x) for x in lines[1:4]), lines
    assert lines[4] == (f"final loss {losses[-1]:.4f} (first "
                        f"{losses[0]:.4f})")
    assert lines[5] == f"checkpoint -> {ckpt}"
    assert len(losses) == 3 and all(np.isfinite(losses))
    loaded, step, extra = checkpoint.load_checkpoint(str(ckpt))
    assert step == 3 and extra == {}
    for a, b in zip(tree_leaves(loaded), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jcfg = jconfigs.get_config(arch).reduced()
    jckpt.save_checkpoint(str(tmp_path / "ref"),
                          jbuild(jcfg).init(jax.random.PRNGKey(0)), step=3)
    with open(ckpt / "manifest.json") as f, \
            open(tmp_path / "ref" / "manifest.json") as g:
        assert json.load(f) == json.load(g)


@pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-large-v2"])
def test_modality_extras_match_the_reference_in_shape_and_repeat(arch):
    cfg = configs.get_config(arch).reduced()
    got = launch_train._modality_extras(cfg, 2, 64, "cpu")
    again = launch_train._modality_extras(cfg, 2, 64, "cpu")
    want = jtrain._modality_extras(jconfigs.get_config(arch).reduced(), 2,
                                   64)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape
        assert got[k].dtype == getattr(torch, jnp.dtype(v.dtype).name)
        assert torch.equal(got[k], again[k])
    assert launch_train._modality_extras(
        configs.get_config("qwen2-7b").reduced(), 2, 64, "cpu") == {}


def test_pod_cli_takes_an_explicit_lr_and_the_remat_flag(capsys):
    launch_train.main(["--mode", "pod", "--device", "cpu", "--arch",
                       "granite-moe-1b-a400m", "--reduced", "--steps", "1",
                       "--batch", "1", "--seq-len", "16", "--lr", "0.05",
                       "--remat", "dots"])
    out = capsys.readouterr().out
    assert "[train] using" not in out and "final loss" in out
    with pytest.raises(ValueError):
        launch_train.main(["--mode", "pod", "--device", "cpu", "--arch",
                           "qwen2-7b", "--reduced", "--steps", "1",
                           "--remat", "offload"])
    with pytest.raises(ValueError, match="LM archs"):
        launch_train.main(["--mode", "pod", "--device", "cpu"])
    if not torch.cuda.is_available():    # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_train.main(["--mode", "pod", "--arch", "qwen2-7b",
                               "--reduced", "--steps", "1"])


# ---------------------------------------------- the FL launcher's repairs

FL_ARGS = ["--mode", "fl", "--method", "fedavg", "--device", "cpu",
           "--rounds", "1", "--devices", "2", "--n-train", "64",
           "--n-test", "32", "--eval-every", "1"]


def _blob(out):
    return json.JSONDecoder().raw_decode(out, out.index("{"))[0]


def test_fl_cli_lr_reaches_the_run(capsys):
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig, run_fl
    launch_train.main(FL_ARGS + ["--lr", "0.1"])
    out = capsys.readouterr().out
    assert "[train] using" not in out
    hist = run_fl(FLRunConfig(method="fedavg", rounds=1, lr=0.1, n_train=64,
                              n_test=32, eval_every=1),
                  FleetConfig(n_devices=2), device="cpu")
    assert _blob(out)["rows"] == json.loads(json.dumps(hist.to_rows()[-1]))
    launch_train.main(FL_ARGS)
    out = capsys.readouterr().out
    assert out.startswith("[train] using the fl-mode default lr 0.05 "
                          "(pass --lr to override)\n")
    assert _blob(out)["rows"]["test_loss"] != hist.rounds[-1].test_loss


def test_fl_cli_event_trace_limit_reaches_the_orchestrator(monkeypatch,
                                                            capsys):
    seen = []
    real = launch_train.run_orchestrated

    def spy(run_cfg, fleet, orch, **kw):
        seen.append(orch.event_trace_limit)
        return real(run_cfg, fleet, orch, **kw)

    monkeypatch.setattr(launch_train, "run_orchestrated", spy)
    launch_train.main(FL_ARGS + ["--event-trace-limit", "4"])
    launch_train.main(FL_ARGS)
    assert seen == [4, None]
    capsys.readouterr()
    with pytest.raises(ValueError, match="event_trace_limit"):
        launch_train.main(FL_ARGS + ["--event-trace-limit", "0"])
    # as the reference's launcher does
    monkeypatch.setattr("sys.argv", ["train"] + FL_ARGS[:2] + [
        "--rounds", "1", "--devices", "2", "--event-trace-limit", "0"])
    with pytest.raises(ValueError, match="event_trace_limit"):
        jtrain.main()
