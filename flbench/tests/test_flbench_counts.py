"""The operation and byte counts against hand counts at small shapes."""
import json
import math

import pytest

import roofline
from reference import host, model as M
from run import HERE

#: FedAvg's FMNIST CNN, which the reference models beside VGG-9
FMNIST = {"model": {"name": "fmnist-cnn", "family": "cnn", "n_layers": 2,
                    "d_model": 32, "d_ff": 512, "vocab_size": 10,
                    "dtype": "float32", "n_params": 1663370}}
VGG9 = json.loads((HERE / "configs" / "vgg9-cifar.json").read_text())


def test_fmnist_forward_at_full_width():
    # conv1 28x28x25x1x32, conv2 14x14x25x32x64, dense 3136x512, 512x10
    macs = 28 * 28 * 25 * 32 + 14 * 14 * 25 * 32 * 64 + 3136 * 512 \
        + 512 * 10
    assert M.forward_flops(FMNIST["model"], 1.0, 1) == 2 * macs
    assert 24.4e6 < 2 * macs < 24.6e6
    assert host.flops_per_sample(FMNIST["model"]) == 3 * 2 * macs


def test_vgg9_forward_at_full_width():
    chans = [3, 64, 64, 128, 128, 256, 256]
    hw = [32, 32, 16, 16, 8, 8]
    macs = sum(hw[i] ** 2 * 9 * chans[i] * chans[i + 1] for i in range(6))
    macs += 16 * 256 * 512 + 512 * 512 + 512 * 10
    assert M.forward_flops(VGG9["model"], 1.0, 3) == 3 * 2 * macs


def test_shrunk_forward_counts_the_kept_widths():
    # alpha 0.25 keeps ceil(size / 2) channels of every group
    w = M.widths(FMNIST["model"], 0.25)
    assert w == {"conv1": 16, "conv2": 32, "dense1": 256}
    macs = 28 * 28 * 25 * 16 + 14 * 14 * 25 * 16 * 32 + 49 * 32 * 256 \
        + 256 * 10
    assert M.forward_flops(FMNIST["model"], 0.25, 2) == 2 * 2 * macs


def test_config_sizes_match_the_models():
    for cfg in (FMNIST, VGG9):
        params = M.init_params(cfg["model"], 0, "cpu")
        assert sum(x.numel() for x in M.leaves(params)) \
            == cfg["model"]["n_params"]


@pytest.mark.parametrize("name,n_bytes,n_flops", [
    ("kernel_l2", 4 * 100 + 4 * 7, 2 * 100 + 7),
    ("fused_sparsify_quantize", 16 * 100 + 4 * 7, 12 * 100),
    ("threshold_apply", 8 * 100 + 8 * 7, 100),
    ("prob_quantize", 20 * 100, 12 * 100),
    ("aio_merge", 24 * 100, 2 * 100),
])
def test_kernel_counts_per_launch(name, n_bytes, n_flops):
    shape = {"N": 100, "K": 7, "agg": []}
    assert roofline.kernel(name).cost(shape, 1) == (n_bytes, n_flops)
    assert roofline.kernel(name).cost(shape, 3) == (3 * n_bytes,
                                                     3 * n_flops)


def test_aio_absorb_counts_the_accumulator_once_a_fold():
    # 15 updates folded into one cell's accumulator: each update and mask
    # read once, the two accumulator planes once in and once out
    shape = {"N": 100, "folds": 1}
    assert roofline.kernel("aio_absorb").cost(shape, 15) == (
        15 * 8 * 100 + 16 * 100, 15 * 4 * 100)
    shape["folds"] = 4
    assert roofline.kernel("aio_absorb").cost(shape, 60)[0] == \
        60 * 8 * 100 + 4 * 16 * 100


def test_aio_aggregate_counts_each_launch_by_its_rows():
    shape = {"agg": [(99, 10), (4, 10), (2, 10)]}
    b, f = roofline.kernel("aio_aggregate").cost(shape, 2)
    assert b == (8 * 4 * 10 + 16 + 40) + (8 * 2 * 10 + 8 + 40)
    assert f == (4 * 4 * 10 + 10) + (4 * 2 * 10 + 10)


def test_aio_aggregate_counts_each_launch_by_its_length():
    # a pod step: one launch a gradient leaf, two pods' rows each
    shape = {"agg": [(2, 7), (2, 1000)]}
    b, f = roofline.kernel("aio_aggregate").cost(shape, 2)
    assert b == (8 * 2 * 7 + 8 + 28) + (8 * 2 * 1000 + 8 + 4000)
    assert f == (4 * 2 * 7 + 7) + (4 * 2 * 1000 + 1000)


def test_bound_is_the_longer_of_bytes_and_operations():
    p = roofline.PEAKS
    assert roofline.bound_s(p["hbm_bytes_per_s"], 0.0) == 1.0
    assert roofline.bound_s(0.0, 2 * p["f32_flops_per_s"]) == 2.0


def test_roofline_share_from_a_trace():
    n = 1_000_000
    ctx = {"shape": {"N": n, "K": 10, "agg": [(60, n)]},
           "launches": {"aio_aggregate": 1, "aio_absorb": 0},
           "trace": {"kernels": {"void aio_kernel(float const*)": 2e-4,
                                 "void other_kernel()": 1.0}}}
    bound = (8 * 60 * n + 240 + 4 * n) / roofline.PEAKS["hbm_bytes_per_s"]
    assert roofline.roofline_share(["aio_aggregate", "aio_absorb"], ctx) \
        == pytest.approx(100 * bound / 2e-4)
    # nothing launched: no reading, never 0
    ctx["launches"] = {}
    assert roofline.roofline_share(["aio_aggregate"], ctx) is None


@pytest.mark.parametrize("name,kernel", [
    ("aio_absorb", "void stream_vec4_kernel<(anonymous namespace)::Absorb>"
                   "(float*, float*, float const*, float const*, long)"),
    ("aio_absorb", "void stream_scalar_kernel<Absorb>(float*)"),
    ("aio_merge", "void stream_vec4_kernel<Merge>(float*)"),
    ("fused_sparsify_quantize", "void fused_vec4_kernel(float const*)"),
    ("kernel_l2", "void tile_sumsq_kernel(float const*, float*, Table)"),
    ("prob_quantize", "void quantize_scalar_kernel(float const*)"),
])
def test_kernel_name_patterns(name, kernel):
    import re
    pats = roofline.kernel(name).PATTERNS
    assert any(re.search(p, kernel) for p in pats)
    others = [m for m in ("aio_absorb", "aio_merge", "fused_sparsify_quantize",
                          "kernel_l2", "prob_quantize", "threshold_apply",
                          "aio_aggregate") if m != name]
    for other in others:
        assert not any(re.search(p, kernel)
                       for p in roofline.kernel(other).PATTERNS)


#: the pod cells' tiny dense decoder (2 layers, d 64, 4 heads of 16,
#: ff 128, vocab 256)
TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "head_dim": 16, "d_ff": 128, "vocab_size": 256}


def test_lm_dense_forward_by_hand():
    lm = roofline.kernel("lm_dense")
    # a layer: q, k, v, o 4 x 64 x 64, gate, up, down 3 x 64 x 128; the
    # unembedding 64 x 256; attention 4 x S x 64 a token a layer
    macs = 2 * (4 * 64 * 64 + 3 * 64 * 128) + 64 * 256
    tokens, S = 2 * 32, 32
    assert lm.forward_flops(TINY, 2, 32) == tokens * (
        2 * macs + 2 * 4 * S * 64)
    # grouped heads: k and v shrink with the key-value heads
    gqa = {**TINY, "n_kv_heads": 1}
    assert lm.forward_flops(TINY, 1, 1) - lm.forward_flops(gqa, 1, 1) \
        == 2 * 2 * 2 * 64 * (64 - 16)


def test_phi3_step_is_six_n_per_token_and_the_attention():
    cfg = json.loads((HERE / "configs" / "phi3-mini-3.8b.json").read_text())
    mdl = cfg["model"]
    B, S = 4, 1024
    step = 3 * roofline.kernel("lm_dense").forward_flops(mdl, B, S)
    d, V, L = mdl["d_model"], mdl["vocab_size"], mdl["n_layers"]
    # 6 N a token over the weights a product reads (all but the
    # embedding table, a gather, and the norms' scales), and 12 L S d
    n_prod = mdl["n_params"] - V * d - (2 * L + 1) * d
    assert step == 6 * n_prod * B * S + 12 * L * S * d * B * S
    assert step == pytest.approx(9.64e13, rel=2e-3)
    # within 3 % of the usual 6 N tokens plus the attention term
    assert step == pytest.approx(6 * mdl["n_params"] * B * S
                                 + 12 * L * S * d * B * S, rel=0.03)


def test_the_pod_layout_holds_the_configured_parameters():
    from reference import lm_dense
    cfg = json.loads((HERE / "configs" / "phi3-mini-3.8b.json").read_text())
    n = sum(math.prod(s) for _, s, _ in lm_dense.leaves(cfg["model"]))
    assert n == cfg["model"]["n_params"] == 3_821_079_552
