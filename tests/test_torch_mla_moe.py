"""DeepSeek-V2-Lite's family in the port (``models/mla_moe.py``) against a
plain float32 model of the same equations (``tests/plain_mla_moe.py``),
at the ``reduced()`` size on seeded random weights: logits, the loss
with its balance term, every leaf's gradient.  Also the dropless MoE
against a per-token loop, YaRN's numbers, the benchmark's row-by-row
reference against the plain model, four planted faults, the counters
and spans of a recorded step, and the normal training paths.

Tolerances: both sides compute in float32 from the same weights, in
another order of operations (the port's blockwise-ready attention, the
grouped products, a sum of k weighted rows against an ``index_add``), so
they part by rounding: a few units of float32's 1.2e-7 on the loss, and
on a gradient leaf's norm of the difference over its norm about 1e-6
(measured 1e-7-2e-6 here).  The limits (``LOSS_RTOL`` 1e-5,
``GRAD_RTOL`` 1e-4, ``LOGIT_ATOL`` 1e-4 on logits of magnitude about
1) leave a factor of ten above that and stay far under what a fault
moves (1e-4 of the loss for the balance term left out, which is 0.001
times a sum near 1 over two layers; 1e-2 and more for the others)."""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

import plain_mla_moe as plain
from repro_torch.configs import ASSIGNED_ARCHS, get_config
from repro_torch.configs.mla_moe import (softmax_scale,
                                         yarn_correction_range)
from repro_torch.kernels import grouped_mm, ops
from repro_torch.launch import steps
from repro_torch.models import mla_moe
from repro_torch.models.registry import build_model
from repro_torch.telemetry import wallclock

ROOT = Path(__file__).resolve().parent.parent
LOSS_RTOL, GRAD_RTOL, LOGIT_ATOL = 1e-5, 1e-4, 1e-4
SEED = 2 ** 31 + 32


def _flatten(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}{k}."))
    return out


def model_dict(cfg) -> dict:
    """The benchmark configuration's ``model`` group of a port config."""
    m, y = cfg.dsmoe, cfg.yarn
    return {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
            "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
            "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
            "tie_embeddings": cfg.tie_embeddings, "dtype": cfg.dtype,
            "kv_lora_rank": cfg.mla.kv_lora_rank,
            "qk_rope_head_dim": cfg.mla.qk_rope_head_dim,
            "first_k_dense_replace": m.first_k_dense,
            "n_routed_experts": m.n_routed_experts,
            "num_experts_per_tok": m.top_k,
            "moe_intermediate_size": m.expert_d_ff,
            "n_shared_experts": m.n_shared_experts,
            "routed_scaling_factor": m.routed_scaling_factor,
            "norm_topk_prob": m.norm_topk_prob,
            "aux_loss_alpha": m.aux_loss_alpha,
            "rope_scaling": {"type": "yarn", "factor": y.factor,
                             "original_max_position_embeddings":
                                 y.original_max_position_embeddings,
                             "beta_fast": y.beta_fast,
                             "beta_slow": y.beta_slow, "mscale": y.mscale,
                             "mscale_all_dim": y.mscale_all_dim}}


CFG = get_config("deepseek-v2-lite").reduced()


def _setup(seq: int = 64, batch: int = 2, cfg=CFG):
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(SEED + 1))
    return model, params, tokens


def port_side(model, params, tokens):
    """(logits, loss, {path: grad}) through the training step's own
    ``value_and_grad`` (remat full)."""
    logits, _ = mla_moe.forward(params, tokens, model.cfg, aux=True,
                                remat="none")
    loss, grads = steps.value_and_grad(model, params, {"tokens": tokens},
                                       remat="full")
    return logits.detach(), float(loss), _flatten(grads)


def plain_side(params, tokens, cfg=CFG):
    flat = {k: v.detach().clone().requires_grad_()
            for k, v in _flatten(params).items()}
    m = model_dict(cfg)
    logits, _ = plain.forward(flat, tokens, m)
    loss = plain.loss(flat, tokens, m)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return logits.detach(), float(loss.detach()), dict(zip(flat, grads))


def gaps(port, ref) -> dict:
    """The worst relative gaps: logits (absolute), loss, any leaf's
    gradient (norm of the difference over the leaf's norm)."""
    (lp, fp, gp), (lr, fr, gr) = port, ref
    grad = max(float((gp[k] - gr[k]).norm() / gr[k].norm().clamp(min=1e-30))
               for k in gr)
    return {"logits": float((lp - lr).abs().max()),
            "loss": abs(fp - fr) / abs(fr), "grad": grad}


def within(g: dict) -> bool:
    return g["logits"] <= LOGIT_ATOL and g["loss"] <= LOSS_RTOL \
        and g["grad"] <= GRAD_RTOL


def test_the_port_matches_the_plain_model():
    model, params, tokens = _setup()
    g = gaps(port_side(model, params, tokens), plain_side(params, tokens))
    assert within(g), g


def test_the_config_and_its_registry_entry():
    full = get_config("deepseek-v2-lite")
    assert full.n_params() == 15_706_484_224
    assert dataclasses.replace(full, n_layers=5).n_params() == 2_839_831_040
    assert "deepseek-v2-lite" not in ASSIGNED_ARCHS
    assert (CFG.n_layers, CFG.d_model, CFG.mla.kv_lora_rank,
            CFG.dsmoe.n_routed_experts, CFG.dsmoe.top_k,
            CFG.dsmoe.n_shared_experts, CFG.vocab_size) \
        == (3, 64, 16, 8, 2, 1, 256)
    n = sum(t.numel() for t in _flatten(
        build_model(CFG).abstract_params()).values())
    assert n == CFG.n_params()


def test_every_leaf_is_stored_in_the_parameters_dtype():
    """The router included (the capacity family keeps its router in
    float32, which the pod step's layout check refuses); granite-moe's
    capacity path keeps its float32 router."""
    cfg = get_config("deepseek-v2-lite")
    leaves = _flatten(build_model(cfg).abstract_params())
    assert {t.dtype for t in leaves.values()} == {torch.bfloat16}
    assert leaves["blocks.experts.w_gate"].shape == (26, 64, 2048, 1408)
    granite = build_model(get_config("granite-moe-1b-a400m"))
    assert granite.abstract_params()["blocks"]["router"]["w"].dtype \
        == torch.float32


def test_the_dropless_moe_matches_a_per_token_loop():
    gen = torch.Generator().manual_seed(SEED)
    p = mla_moe.init_moe_block(gen, CFG)
    h = torch.randn(2, 24, CFG.d_model, generator=gen)
    y, aux = mla_moe.moe_ffn(p, h, CFG)
    x = h.reshape(-1, CFG.d_model)
    w, idx, _ = mla_moe.route(p["router"], x, CFG)
    ex, sh = p["experts"], p["shared"]
    want = []
    for t in range(x.shape[0]):
        acc = torch.zeros(CFG.d_model)
        for k in range(CFG.dsmoe.top_k):
            e = int(idx[t, k])
            acc += w[t, k] * plain.swiglu(x[t], ex["w_gate"][e],
                                          ex["w_up"][e], ex["w_down"][e])
        want.append(acc + plain.swiglu(x[t], sh["w_gate"], sh["w_up"],
                                       sh["w_down"]))
    torch.testing.assert_close(y.reshape(-1, CFG.d_model),
                               torch.stack(want), rtol=1e-5, atol=1e-6)
    assert aux.dim() == 0 and float(aux) > 0


def test_yarn_frequencies_and_scale_are_the_formulas_numbers():
    full = get_config("deepseek-v2-lite")
    # d(b) = 64 ln(4096 / (2 pi b)) / (2 ln 10000): 10.47 at b 32, 22.51
    # at b 1
    assert yarn_correction_range(32, 1, 64, 10000, 4096) == (10, 23)
    f = mla_moe.yarn_inv_freq(full)
    i = torch.arange(32, dtype=torch.float64)
    base = 10000.0 ** (-2 * i / 64)
    ramp = ((i - 10) / 13).clamp(0, 1)
    want = base * (1 - ramp) + base / 40 * ramp
    torch.testing.assert_close(f.double(), want, rtol=1e-6, atol=0)
    assert float(f[0]) == 1.0 and abs(float(f[31]) - float(base[31]) / 40) \
        < 1e-12
    # (128 + 64) ** -0.5 * (0.1 * 0.707 * ln 40 + 1) ** 2
    assert softmax_scale(full) == pytest.approx(0.11472, rel=1e-4)
    assert softmax_scale(full) == pytest.approx(
        192 ** -0.5 * (0.0707 * 3.6888794541139363 + 1) ** 2, rel=1e-12)


def test_blockwise_attention_takes_a_narrower_value_and_a_scale():
    """The cell attends blockwise (4096 tokens): 192-wide queries and
    keys, 128-wide values, MLA's scale; here 24 and 16 wide over 256
    tokens in blocks of 64, against the dense path and a plain softmax."""
    from repro_torch.models import attention
    gen = torch.Generator().manual_seed(SEED)
    q, k = (torch.randn(2, 256, 4, 24, generator=gen) for _ in range(2))
    v = torch.randn(2, 256, 4, 16, generator=gen)
    pos = torch.arange(256)
    blk = attention.attention_blockwise(q, k, v, pos, pos, block_q=64,
                                        block_kv=64, scale=0.3)
    dense = attention.attend(q, k, v, pos, pos, scale=0.3)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.3
    s = s.masked_fill(~torch.ones(256, 256, dtype=torch.bool).tril(),
                      float("-inf"))
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v)
    for got in (blk, dense):
        assert got.shape == (2, 256, 4, 16)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _flbench_reference():
    spec = importlib.util.spec_from_file_location(
        "flbench_lm_mla_moe", ROOT / "flbench" / "reference" / "lm_mla_moe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_benchmarks_reference_gives_the_plain_models_loss_and_grads():
    """The benchmark's row-by-row reference and the plain model are two
    copies of the same equations: they must not drift apart."""
    ref = _flbench_reference()
    model, params, tokens = _setup(seq=32, batch=3)
    flat = {k: v.detach() for k, v in _flatten(params).items()}
    assert {p: tuple(s) for p, s, _ in ref.leaves(model_dict(CFG))} \
        == {k: tuple(v.shape) for k, v in flat.items()}
    cfg = {"model": model_dict(CFG), "rms_norm_eps": 1e-6,
           "sliding_window": None}
    loss, grads = ref.loss_and_grads(flat, tokens, cfg)
    _, ploss, pgrads = plain_side(params, tokens)
    assert abs(loss - ploss) / abs(ploss) <= LOSS_RTOL
    for k, g in pgrads.items():
        assert float((grads[k] - g).norm() / g.norm()) <= GRAD_RTOL, k


# -------------------------------------------------------- planted faults

def _capacity_dispatch(fn):
    """``experts_dropless`` with the assignments past 1.25x the mean load
    of their expert dropped, in token order, as the capacity family
    does."""
    def dropped(ex, h, w, idx, cfg):
        E, K = cfg.dsmoe.n_routed_experts, idx.shape[1]
        cap = max(int(1.25 * h.shape[0] * K / E), 1)
        onehot = torch.nn.functional.one_hot(idx.reshape(-1), E)
        slot = (onehot.cumsum(0) - onehot).mul(onehot).sum(-1)
        keep = (slot < cap).view_as(w)
        assert not bool(keep.all()), "nothing dropped: the fault is vacuous"
        return fn(ex, h, w * keep, idx, cfg)
    return dropped


def _renormalised(fn):
    """``route`` with the top-k weights renormalised to sum to one."""
    def route(router, h, cfg):
        w, idx, scores = fn(router, h, cfg)
        return w / w.sum(-1, keepdim=True), idx, scores
    return route


def _no_balance_loss(fn):
    """``balance_loss`` left out."""
    return lambda scores, idx, B, cfg: scores.new_zeros(())


def _half_split_rope(fn):
    """``apply_rope`` without DeepSeek's interleave: the pairs taken as
    they lie, half against half (Llama's layout)."""
    def rope(x, positions, cfg):
        B, S, h, dr = x.shape
        # undo the de-interleave that ``fn`` applies first
        y = x.reshape(B, S, h, 2, dr // 2).transpose(-1, -2).reshape(
            B, S, h, dr)
        return fn(y, positions, cfg)
    return rope


FAULTS = {"capacity": ("experts_dropless", _capacity_dispatch),
          "renormalised": ("route", _renormalised),
          "no_balance": ("balance_loss", _no_balance_loss),
          "half_split_rope": ("apply_rope", _half_split_rope)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_the_comparison(fault, monkeypatch):
    model, params, tokens = _setup()
    ref = plain_side(params, tokens)
    name, make = FAULTS[fault]
    monkeypatch.setattr(mla_moe, name, make(getattr(mla_moe, name)))
    g = gaps(port_side(model, params, tokens), ref)
    assert not within(g), g


# ------------------------------------------------- tracing and the paths

def test_a_recorded_step_carries_the_spans_and_counters():
    model, params, tokens = _setup(seq=32)
    with wallclock.recording() as rec:
        steps.value_and_grad(model, params, {"tokens": tokens},
                             remat="full")
    spans = rec.spans()
    for name in ("mla.project", "mla.attend", "moe.route", "moe.dispatch",
                 "moe.experts", "moe.combine", "moe.shared"):
        assert spans[name].calls > 0, name
    c = rec.counters()
    rows = tokens.numel() * CFG.dsmoe.top_k * CFG.n_moe_layers
    assert c["moe.rows"] == rows and c["moe.dropped"] == 0
    assert rows / (CFG.dsmoe.n_routed_experts * CFG.n_moe_layers) \
        <= c["moe.rows_max"] <= tokens.numel() * CFG.n_moe_layers
    # nothing is read while nobody records
    with wallclock.recording() as outer:
        pass
    assert outer.counters() == {}


def test_the_grouped_products_plain_versions_and_gradients():
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn(10, 8, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    w = torch.randn(4, 8, 6, generator=gen, dtype=torch.float64,
                    requires_grad=True)
    offs = torch.tensor([3, 3, 7, 10], dtype=torch.int32)
    ops.reset_launch_counts()
    torch.autograd.gradcheck(lambda a, b: ops.grouped_mm_op(a, b, offs),
                             (x, w))
    bounds = [(0, 3), (3, 3), (3, 7), (7, 10)]
    want = torch.cat([x[a:b] @ w[g] for g, (a, b) in enumerate(bounds)])
    torch.testing.assert_close(ops.grouped_mm_op(x, w, offs), want)
    # the CPU route launches nothing
    assert ops.launch_counts()["grouped_mm"] == 0


def test_run_pod_trains_it(tmp_path):
    """``launch/train.run_pod``, the pod trainer's entry, under its
    sharding context on a one-rank host mesh."""
    from repro_torch.launch.train import run_pod
    args = argparse.Namespace(device="cpu", arch="deepseek-v2-lite",
                              reduced=True, lr=3e-3, seed=5, batch=2,
                              seq_len=32, steps=3, remat="full",
                              checkpoint=None)
    losses, params = run_pod(args)
    assert len(losses) == 3 and all(torch.isfinite(torch.tensor(losses)))
    assert set(_flatten(params)) == set(_flatten(
        build_model(CFG).abstract_params()))


def test_the_serve_path_is_not_there():
    model = build_model(CFG)
    with pytest.raises(NotImplementedError):
        model.init_cache(1, 8, "cpu")


@pytest.mark.gpu
def test_the_grouped_gemm_on_the_card(cuda):
    """The card's grouped products against the plain loop on the same
    bf16 operands at DeepSeek-V2-Lite's expert widths, an empty group
    among them, and the launch counters."""
    gen = torch.Generator(device=cuda).manual_seed(SEED)
    E, k, n = 64, 2048, 1408
    counts = torch.randint(0, 200, (E,), generator=gen, device=cuda)
    counts[5] = 0
    offs = counts.cumsum(0).to(torch.int32)
    M = int(offs[-1])
    x = torch.randn(M, k, generator=gen, device=cuda, dtype=torch.bfloat16)
    w = torch.randn(E, k, n, generator=gen, device=cuda,
                    dtype=torch.bfloat16) / 45
    dy = torch.randn(M, n, generator=gen, device=cuda, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    for got, want in (
            (grouped_mm.grouped_mm(x, w, offs),
             grouped_mm.grouped_mm_ref(x, w, offs)),
            (grouped_mm.grouped_mm(dy, w.transpose(1, 2), offs),
             grouped_mm.grouped_mm_ref(dy, w.transpose(1, 2), offs)),
            (grouped_mm.grouped_mm_t(x, dy, offs),
             grouped_mm.grouped_mm_t_ref(x.float(), dy.float(), offs))):
        err = (got.float() - want.float()).norm() / want.float().norm()
        # bf16 products summed in float32 on both sides, rounded to bf16
        # at the end: a few bf16 units (2^-8) of relative error at most
        assert float(err) < 8e-3
    c = ops.launch_counts()
    assert c["grouped_mm"] == 3
    assert c["grouped_mm_macs"] == 3 * M * k * n
    assert c["grouped_mm_elems"] == 3 * (M * k + E * k * n + M * n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
