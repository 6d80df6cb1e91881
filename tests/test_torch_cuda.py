"""The port's CUDA kernels on a card, against their plain PyTorch versions.

Every test here needs a CUDA card and skips without one; the file
imports no JAX, so it runs on a machine that has only PyTorch:

  python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: level indices, the kept support, masks, the threshold step
(flat and per view, masked values and keep flags) and the aggregation
(batched and streaming) exact (same float32 operations in the same
order, no FMA contraction); quantized values rtol 1e-6; norms rtol 1e-5
(the plain version sums in another order), and bitwise equal between two
calls of the kernel (it sums in a fixed order).  LM serving (plain
PyTorch on the card, no kernel of the port): reduced float32 models
against the CPU at rtol/atol 1e-4, blockwise attention against dense at
the reference's 2e-5.  The pod trainer's step (plain PyTorch too): the
loss at 1e-4 and each gradient leaf within 1e-4 of its largest |g|,
card against CPU, and one AdamW step's parameters within 2 lr.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.compression import (_element_mask,  # noqa: E402
                                          _leaf_views)
from repro_torch.kernels import (aio_agg, fused_compress, ops,  # noqa: E402
                                 quantize, ref, sparsify)

pytestmark = pytest.mark.gpu

#: the fmnist-cnn update's leaves, in sorted-key order
FMNIST_SHAPES = [(32,), (5, 5, 1, 32), (64,), (5, 5, 32, 64), (512,),
                 (3136, 512), (10,), (512, 10)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _leaf_views_on(device, seed=11):
    """Per-leaf (K, ksize) views of an update and its uniforms, as the
    main path hands them to the kernels (strides (1, K))."""
    n = sum(int(np.prod(s)) for s in FMNIST_SHAPES)
    rng = np.random.default_rng(seed)
    vec = torch.tensor(rng.standard_normal(n).astype(np.float32) * 1e-2,
                       device=device)
    rand = torch.tensor(rng.uniform(size=n).astype(np.float32),
                        device=device)
    return _leaf_views(vec, FMNIST_SHAPES), _leaf_views(rand, FMNIST_SHAPES)


def test_norm_and_fused_kernels_match_plain_versions(cuda):
    views, rands = _leaf_views_on(cuda)
    for x, r in zip(views, rands):
        norms = sparsify.kernel_l2(x)
        torch.testing.assert_close(norms, ref.kernel_l2_ref(x), rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(sparsify.kernel_sumsq(x),
                                   ref.kernel_sumsq_ref(x), rtol=1e-5,
                                   atol=0)
        thr = float(norms.median())
        for levels in (2.0, 64.0, 37.25):
            args = (x, norms, thr, 1e-4, float(x.abs().max()), levels, r)
            q, lvl = fused_compress.fused_sparsify_quantize(*args)
            qr, lr = ref.fused_sparsify_quantize_ref(*args)
            assert q.stride() == x.stride()
            assert torch.equal(lvl, lr)
            assert torch.equal(q, qr)


@pytest.mark.parametrize("shapes", [
    FMNIST_SHAPES,
    [(6,), (3, 3, 2, 6), (17,), (24, 10)],
    [(5, 5, 1, 32), (32,), (40, 33), (1,)],
    [(7,), (300, 70), (70,)],
])
def test_flat_norms_match_plain_version_and_are_stable(cuda, shapes):
    """One call over the whole update: the plain version's norms within
    rtol 1e-5, and the same bits from a second call."""
    n = sum(int(np.prod(s)) for s in shapes)
    rng = np.random.default_rng(n)
    vec = torch.tensor(rng.standard_normal(n).astype(np.float32) * 1e-2,
                       device=cuda)
    for kernel, plain in ((sparsify.kernel_sumsq_flat,
                           ref.kernel_sumsq_flat_ref),
                          (sparsify.kernel_l2_flat, ref.kernel_l2_flat_ref)):
        got = kernel(vec, shapes)
        torch.testing.assert_close(got, plain(vec, shapes), rtol=1e-5,
                                   atol=0)
        assert torch.equal(got, kernel(vec, shapes))


def test_fused_kernel_takes_row_major_views(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(300, 77, generator=g, device=cuda)
    r = torch.rand(300, 77, generator=g, device=cuda)
    norms = sparsify.kernel_l2(x)
    args = (x, norms, float(norms.median()), 0.01, 3.0, 16.0, r)
    q, lvl = fused_compress.fused_sparsify_quantize(*args)
    qr, lr = ref.fused_sparsify_quantize_ref(*args)
    assert torch.equal(lvl, lr) and torch.equal(q, qr)


#: leaves that start off a 16-byte boundary (offsets 7 and 21007), N % 4 = 1
MISALIGNED_SHAPES = [(7,), (300, 70), (70,)]


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shapes", [FMNIST_SHAPES, MISALIGNED_SHAPES])
def test_flat_fused_kernel_matches_plain_version(cuda, shapes, offset):
    """One launch over the whole update against the per-leaf plain version
    laid out flat: levels and the kept support exact, values rtol 1e-6;
    ``offset`` 1 starts the planes off a 16-byte boundary (the scalar
    loop)."""
    n = sum(int(np.prod(s)) for s in shapes)
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    vec = (torch.randn(n + offset, generator=g, device=cuda) * 1e-2)[offset:]
    rand = torch.rand(n + offset, generator=g, device=cuda)[offset:]
    norms = sparsify.kernel_l2_flat(vec, shapes)
    thr = float(norms.median())
    for levels in (2.0, 64.0, 37.25):
        args = (vec, shapes, norms, thr, 1e-4, float(vec.abs().max()),
                levels, rand)
        before = fused_compress.launches["fused_sparsify_quantize"]
        q, lvl = fused_compress.fused_sparsify_quantize_flat(*args)
        assert fused_compress.launches["fused_sparsify_quantize"] \
            == before + 1
        qr, lr = ref.fused_sparsify_quantize_flat_ref(*args)
        assert torch.equal(lvl, lr)
        assert torch.equal(q != 0, qr != 0)
        torch.testing.assert_close(q, qr, rtol=1e-6, atol=0)


def test_aio_kernel_matches_plain_version_at_main_path_shape(cuda):
    n = sum(int(np.prod(s)) for s in FMNIST_SHAPES)
    g = torch.Generator(device=cuda).manual_seed(1)
    u = torch.randn(12, n, generator=g, device=cuda)
    m = (torch.rand(12, n, generator=g, device=cuda) > 0.5).float()
    m[:, :100] = 0.0                       # uncovered coordinates give 0
    w = torch.rand(12, generator=g, device=cuda)
    got = aio_agg.aio_aggregate(u, m, w)
    assert torch.equal(got, ref.aio_aggregate_ref(u, m, w))
    assert torch.equal(got[:100], torch.zeros(100, device=cuda))


def test_the_first_kernel_call_times_the_library_load(cuda, monkeypatch):
    """Under a recorder, the first launch of a kernel whose library this
    process has not loaded yet records one ``setup.kernels`` span (the
    build if the cache lacks the library, and the load); later launches
    record none."""
    from repro_torch.kernels import build
    from repro_torch.telemetry import wallclock
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_FUNCS", {})
    monkeypatch.setattr(aio_agg._AGGREGATE, "_fn", None)
    u = torch.ones(3, 1000, device=cuda)
    w = torch.ones(3, device=cuda)
    with wallclock.recording() as rec:
        aio_agg.aio_aggregate(u, u, w)
        first = rec.spans()
        for _ in range(3):
            aio_agg.aio_aggregate(u, u, w)
    assert first["setup.kernels"].calls == 1
    assert rec.spans()["setup.kernels"].calls == 1
    assert first["setup.kernels"].total_ns > 0


def test_threshold_and_quantize_kernels_match_plain_versions(cuda):
    """#3 over the whole flat update in one launch, then #4 over the flat
    masked vector, as the beta planner runs them."""
    n = sum(int(np.prod(s)) for s in FMNIST_SHAPES)
    g = torch.Generator(device=cuda).manual_seed(12)
    vec = torch.randn(n, generator=g, device=cuda) * 1e-2
    rand = torch.rand(n, generator=g, device=cuda)
    norms = sparsify.kernel_l2_flat(vec, FMNIST_SHAPES)
    thr = float(norms.median())
    before = sparsify.launches["threshold_apply"]
    flat, keep = sparsify.threshold_apply_flat(vec, FMNIST_SHAPES, norms, thr)
    assert sparsify.launches["threshold_apply"] == before + 1
    want, want_keep = ref.threshold_apply_flat_ref(vec, FMNIST_SHAPES, norms,
                                                   thr)
    assert torch.equal(flat, want) and torch.equal(keep, want_keep)
    mask = _element_mask(keep, FMNIST_SHAPES)
    av = flat.abs()[mask > 0]
    for levels in (2.0, 256.0, 37.25):
        args = (flat, mask, float(av[av > 0].min()), float(av.max()),
                levels, rand)
        q, lvl = quantize.prob_quantize(*args)
        qr, lr = ref.quantize_ref(*args)
        assert torch.equal(lvl, lr)
        torch.testing.assert_close(q, qr, rtol=1e-6, atol=0)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shapes", [FMNIST_SHAPES, MISALIGNED_SHAPES])
def test_flat_threshold_kernel_matches_plain_version(cuda, shapes, offset):
    """One launch over the whole update against the per-leaf plain version
    laid out flat, exactly (masked vector and keep); ``offset`` 1 starts
    the planes off a 16-byte boundary (the scalar loop).  A dead kernel
    (norm 0) is dropped at the median and kept at a threshold of 0."""
    n = sum(int(np.prod(s)) for s in shapes)
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    vec = (torch.randn(n + offset, generator=g, device=cuda) * 1e-2)[offset:]
    K, C = ref.leaf_kernel_shape(shapes[-1])
    vec[n - K * C:].view(C, K)[:, 0] = 0.0
    norms = sparsify.kernel_l2_flat(vec, shapes)
    for thr in (float(norms.median()), 0.0):
        before = sparsify.launches["threshold_apply"]
        got, keep = sparsify.threshold_apply_flat(vec, shapes, norms, thr)
        assert sparsify.launches["threshold_apply"] == before + 1
        want, want_keep = ref.threshold_apply_flat_ref(vec, shapes, norms,
                                                       thr)
        assert torch.equal(got, want) and torch.equal(keep, want_keep)


@pytest.mark.parametrize("layout", ["kernel_fastest", "row_major"])
def test_threshold_kernel_takes_a_single_view(cuda, layout):
    """The single-view call, a one-segment table through the same C entry:
    exact, laid out like its view."""
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(77, 300, generator=g, device=cuda)
    if layout == "kernel_fastest":
        x = x.t()
    norms = sparsify.kernel_l2(x)
    got, keep = sparsify.threshold_apply(x, norms, float(norms.median()))
    want, want_keep = ref.threshold_mask_ref(x, norms, float(norms.median()))
    assert got.stride() == x.stride()
    assert torch.equal(got, want) and torch.equal(keep, want_keep)


@pytest.mark.parametrize("n,offset", [
    (sum(int(np.prod(s)) for s in FMNIST_SHAPES), 0),
    *((k, 0) for k in range(1, 8)),
    (sum(int(np.prod(s)) for s in FMNIST_SHAPES), 1),
])
def test_quantize_kernel_exact_at_every_length_and_alignment(cuda, n,
                                                             offset):
    """#4's float4 loop with its N % 4 tail, and the scalar loop for
    planes that start ``offset`` elements off their buffers: levels
    exact, values rtol 1e-6, one launch."""
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    v = (torch.randn(n + offset, generator=g, device=cuda) * 1e-2)[offset:]
    mask = (torch.rand(n + offset, generator=g, device=cuda)
            > 0.3).float()[offset:]
    rand = torch.rand(n + offset, generator=g, device=cuda)[offset:]
    av = (v.abs() * mask)
    u_min = float(av[av > 0].min()) if bool((av > 0).any()) else 0.0
    for levels in (2.0, 64.0, 37.25):
        args = (v, mask, u_min, float(av.max()), levels, rand)
        before = quantize.launches["prob_quantize"]
        q, lvl = quantize.prob_quantize(*args)
        assert quantize.launches["prob_quantize"] == before + 1
        qr, lr = ref.quantize_ref(*args)
        assert torch.equal(lvl, lr)
        torch.testing.assert_close(q, qr, rtol=1e-6, atol=0)


def test_absorb_and_merge_kernels_are_exact_and_in_place(cuda):
    """Both write into the caller's accumulator, return nothing, and agree
    with the plain versions bit for bit; merge leaves its b side alone."""
    n = sum(int(np.prod(s)) for s in FMNIST_SHAPES)
    g = torch.Generator(device=cuda).manual_seed(3)
    u = torch.randn(n, generator=g, device=cuda)
    m = (torch.rand(n, generator=g, device=cuda) > 0.5).float()
    b_side = (u.clone(), m.clone())
    for kernel, plain, operands in (
            (aio_agg.aio_absorb, ref.aio_absorb_ref, (u, m, 0.3712)),
            (aio_agg.aio_merge, ref.aio_merge_ref, b_side)):
        acc = (torch.randn(n, generator=g, device=cuda),
               torch.rand(n, generator=g, device=cuda))
        want = plain(*acc, *operands)
        ptrs = [t.data_ptr() for t in acc]
        assert kernel(*acc, *operands) is None
        assert [t.data_ptr() for t in acc] == ptrs
        assert torch.equal(acc[0], want[0]) and torch.equal(acc[1], want[1])
    assert torch.equal(b_side[0], u) and torch.equal(b_side[1], m)


@pytest.mark.parametrize("n,offset", [
    (sum(int(np.prod(s)) for s in FMNIST_SHAPES), 0),
    *((k, 0) for k in range(1, 8)),
    (sum(int(np.prod(s)) for s in FMNIST_SHAPES), 1),
])
@pytest.mark.parametrize("kernel", ["aio_merge", "aio_absorb"])
def test_merge_kernel_exact_at_every_length_and_alignment(cuda, kernel, n,
                                                          offset):
    """The streaming pair's float4 loop with its N % 4 tail, and the
    scalar loop for a plane that starts ``offset`` elements off its buffer
    (off a 16-byte boundary for offset 1): bit for bit, in place."""
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    planes = [torch.randn(n + offset, generator=g, device=cuda)[offset:]
              for _ in range(4)]
    extra = (0.3712,) if kernel == "aio_absorb" else ()
    want = getattr(ref, f"{kernel}_ref")(*planes, *extra)
    ptrs = [t.data_ptr() for t in planes[:2]]
    getattr(aio_agg, kernel)(*planes, *extra)
    assert [t.data_ptr() for t in planes[:2]] == ptrs
    assert torch.equal(planes[0], want[0]) and torch.equal(planes[1], want[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.ones(4, 8, device=cuda)
    with pytest.raises(TypeError):
        sparsify.kernel_l2(x.double())
    flat = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        sparsify.kernel_l2_flat(flat.double(), [(8, 8)])
    with pytest.raises(ValueError):
        sparsify.kernel_l2_flat(flat[:60], [(8, 8)])
    with pytest.raises(ValueError):
        sparsify.kernel_l2_flat(torch.ones(128, device=cuda)[::2], [(8, 8)])
    with pytest.raises(ValueError):
        sparsify.kernel_l2_flat(torch.ones(65, device=cuda), [(1,)] * 65)
    with pytest.raises(ValueError):
        fused_compress.fused_sparsify_quantize(
            x[:, ::2], torch.ones(4, device=cuda), 0.0, 0.0, 1.0, 2.0,
            x[:, ::2])
    with pytest.raises(ValueError):
        aio_agg.aio_aggregate(x.t(), x.t(), torch.ones(8, device=cuda))
    v = torch.ones(64, device=cuda)
    with pytest.raises(ValueError):
        sparsify.threshold_apply(x[:, ::2], torch.ones(4, device=cuda), 0.5)
    with pytest.raises(ValueError):
        sparsify.threshold_apply(x, torch.ones(4, device=cuda).cpu(), 0.5)
    with pytest.raises(TypeError):
        sparsify.threshold_apply(x.double(), torch.ones(4, device=cuda), 0.5)
    with pytest.raises(TypeError):
        quantize.prob_quantize(v.double(), v, 0.0, 1.0, 2.0, v)
    with pytest.raises(ValueError):
        quantize.prob_quantize(v[::2], v[:32], 0.0, 1.0, 2.0, v[:32])
    with pytest.raises(ValueError):
        quantize.prob_quantize(v, v.cpu(), 0.0, 1.0, 2.0, v)
    nk = torch.ones(8, device=cuda)
    for vec, rand, norms, err in (
            (v.cpu(), v.cpu(), nk.cpu(), ValueError),    # CPU planes
            (v, v, nk.cpu(), ValueError),                # norms off the card
            (v.double(), v, nk, TypeError),
            (v, v[:60], nk, ValueError),                 # a short plane
            (v, v, nk[:7], ValueError)):                 # short norms
        with pytest.raises(err):
            fused_compress.fused_sparsify_quantize_flat(
                vec, [(8, 8)], norms, 0.5, 0.0, 1.0, 2.0, rand)
    for vec, norms, err in (
            (v.cpu(), nk.cpu(), ValueError),             # CPU planes
            (v, nk.cpu(), ValueError),                   # norms off the card
            (v.double(), nk, TypeError),
            (v[:60], nk, ValueError),                    # a short plane
            (torch.ones(128, device=cuda)[::2], nk, ValueError),
            (v, nk[:7], ValueError)):                    # short norms
        with pytest.raises(err):
            sparsify.threshold_apply_flat(vec, [(8, 8)], norms, 0.5)
    for call in (aio_agg.aio_absorb, aio_agg.aio_merge):
        extra = (0.5,) if call is aio_agg.aio_absorb else ()
        with pytest.raises(ValueError):
            call(v.cpu(), v.cpu(), v.cpu(), v.cpu(), *extra)
        with pytest.raises(ValueError):
            call(v[::2], v[:32], v[:32], v[:32], *extra)
        with pytest.raises(TypeError):
            call(v.double(), v, v, v, *extra)


def test_cuda_round_goes_through_every_kernel(cuda):
    """A flat round with the planner launches #1-#6, the norms once per
    compressed update and planner probe, the fused step once per
    compressed update, #3 once per planner rho (8) and #4 once per
    (rho, L) (80); a hierarchical one #7 and #8 and not #6."""
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.topology import TopologyConfig
    from repro_torch.train.fl_loop import FLRunConfig, run_fl
    cfg = FLRunConfig(rounds=1, n_train=128, n_test=32, eval_every=1, seed=3)
    ops.reset_launch_counts()
    hist = run_fl(cfg, FleetConfig(n_devices=3), device="cuda")
    counts = ops.launch_counts()
    flat = {k for k, v in counts.items() if v > 0}
    assert flat == set(counts) - {"aio_absorb", "aio_merge"}, counts
    updates = sum(r.n_clients + r.n_dropped for r in hist.rounds)
    assert counts["kernel_l2"] == counts["kernel_sumsq"] == updates + 1
    assert counts["fused_sparsify_quantize"] == updates
    assert counts["threshold_apply"] == 8
    assert counts["prob_quantize"] == 80
    assert np.isfinite(hist.rounds[-1].test_loss)
    ops.reset_launch_counts()
    hist = run_fl(cfg, FleetConfig(n_devices=4, topology=TopologyConfig(
        kind="hier", n_cells=2)), device="cuda")
    counts = ops.launch_counts()
    assert counts["aio_absorb"] == hist.rounds[0].n_clients > 0, counts
    assert counts["aio_merge"] == hist.rounds[0].n_cells_reporting - 1 == 1
    assert counts["aio_aggregate"] == 0
    assert np.isfinite(hist.rounds[-1].test_loss)


def _fmnist_update(device, seed):
    """An update of the fmnist-cnn leaves (sorted-key order) and one
    uniform per element, from numpy, on ``device``."""
    n = sum(int(np.prod(s)) for s in FMNIST_SHAPES)
    rng = np.random.default_rng(seed)
    vec = torch.tensor(rng.standard_normal(n).astype(np.float32) * 1e-2,
                       device=device)
    rand = torch.tensor(rng.uniform(size=n).astype(np.float32),
                        device=device)
    tree, off = {}, 0
    for i, s in enumerate(FMNIST_SHAPES):
        k = int(np.prod(s))
        tree[f"l{i:02d}"] = vec[off:off + k].view(s)
        off += k
    return tree, rand


@pytest.mark.parametrize("method,n_levels", [
    ("qsgd", 16), ("fedhq", 2), ("fedhq", 181), ("fedhq", 65536)])
def test_quantizing_baselines_on_the_card_match_the_cpu_route(
        cuda, method, n_levels):
    """QSGD (top-k mask at 1/16) and FedHQ (every element, up to 65536
    levels) quantize with one prob_quantize launch on the card: the same
    mask and level indices as the CPU route, values rtol 1e-6, bits rtol
    1e-5 (the entropy histogram sums in another order)."""
    from repro_torch.train import baselines
    out = {}
    for device in ("cpu", cuda):
        tree, rand = _fmnist_update(device, seed=n_levels)
        vec = torch.cat([t.reshape(-1) for t in tree.values()])
        mask = baselines._topk_mask(vec, 1.0 / 16.0) if method == "qsgd" \
            else torch.ones_like(vec)
        before = quantize.launches["prob_quantize"]
        q = baselines._quantize(vec, mask, n_levels, rand)
        launched = quantize.launches["prob_quantize"] - before
        comp = baselines.qsgd_compress(tree, 1.0 / 16.0, n_levels, rand) \
            if method == "qsgd" else baselines.fedhq_compress(tree, n_levels,
                                                              rand)
        out[str(device)] = (launched, mask.cpu(), q.levels.cpu(),
                            q.values.cpu(), comp)
    (n_cpu, m_cpu, l_cpu, v_cpu, c_cpu), (n_gpu, m_gpu, l_gpu, v_gpu,
                                          c_gpu) = out["cpu"], out["cuda"]
    assert (n_cpu, n_gpu) == (0, 1)
    assert torch.equal(m_gpu, m_cpu)
    assert torch.equal(l_gpu, l_cpu)
    assert int(l_gpu.max()) <= n_levels
    torch.testing.assert_close(v_gpu, v_cpu, rtol=1e-6, atol=0)
    for a, b in zip(c_gpu.values.values(), c_cpu.values.values()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(c_gpu.bits), float(c_cpu.bits),
                               rtol=1e-5)


def test_uveqfed_on_the_card_matches_the_cpu_route(cuda):
    """UVeQFed's dithered quantizer in plain PyTorch: the same mask, level
    indices and bits on the card as on the CPU, values rtol 1e-6."""
    from repro_torch.train import baselines
    comps, levels = [], []
    for device in ("cpu", cuda):
        tree, rand = _fmnist_update(device, seed=4)
        comps.append(baselines.uveqfed_compress(tree, 1.0 / 16.0, 16, rand))
        vec = torch.cat([t.reshape(-1) for t in tree.values()])
        levels.append(baselines.dither_quantize(
            vec, baselines._topk_mask(vec, 1.0 / 16.0), 16, rand)[1].cpu())
    assert torch.equal(levels[1], levels[0])
    for a, b in zip(comps[1].mask.values(), comps[0].mask.values()):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(comps[1].values.values(), comps[0].values.values()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-6, atol=0)
    np.testing.assert_allclose(float(comps[1].bits), float(comps[0].bits),
                               rtol=1e-5)


@pytest.mark.parametrize("method", ["stc", "qsgd", "uveqfed", "heterofl",
                                    "fedhq", "fedavg"])
def test_flat_baseline_round_launches_quantize_and_aggregate(cuda, method):
    """A flat baseline round: #6 once per round, #4 once per QSGD or FedHQ
    update, and no planner or FGC kernel."""
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig, run_fl
    ops.reset_launch_counts()
    hist = run_fl(FLRunConfig(method=method, rounds=1, n_train=128,
                              n_test=32, eval_every=1, seed=3),
                  FleetConfig(n_devices=3), device="cuda")
    counts = ops.launch_counts()
    n_upd = hist.rounds[0].n_clients
    assert n_upd == 3
    assert counts["aio_aggregate"] == 1
    assert counts["prob_quantize"] == (n_upd if method in ("qsgd", "fedhq")
                                       else 0)
    assert not any(counts[k] for k in ("kernel_sumsq", "kernel_l2",
                                       "threshold_apply",
                                       "fused_sparsify_quantize",
                                       "aio_absorb", "aio_merge")), counts
    assert np.isfinite(hist.rounds[-1].test_loss)


@pytest.mark.parametrize("name,alpha,dtype", [
    ("fmnist-cnn", 0.55, "float32"), ("vgg9-cifar", 0.25, "float64"),
    ("vgg9-cifar", 0.4, "float64"), ("vgg9-cifar", 1.0, "float64")])
def test_vmapped_group_of_four_lanes_matches_the_loop_on_the_card(
        cuda, name, alpha, dtype):
    """The client pool's batched step: one vmapped group of 4 lanes, from
    shared and from stacked parameters, against each client's own
    ``_local_steps`` on the card, 2 steps each on the synthetic task's
    images as the runs train them, fmnist-cnn and VGG-9 at the cell's
    three widths: parameters within rtol 1e-5, beside an absolute 1e-5 of
    the leaf's largest magnitude (the lanes' batched GEMMs sum in another
    order than cuDNN).  On white-noise images a near-tie of a max-pool
    window can route one lane's gradient elsewhere (seen on the CPU at
    2.2e-5 of the update's norm), which no float tolerance covers.  VGG-9
    pools a hundred times more windows a step, and in float32 such
    near-ties route a lane's gradient elsewhere at every width (3e-2 of a
    leaf after two steps, on the card); it runs in float64, where the
    same code keeps them apart."""
    from repro_torch.configs import get_config
    from repro_torch.core import shrinking
    from repro_torch.core.anycost import AnycostClient
    from repro_torch.data.synthetic import make_image_task
    from repro_torch.device import resolve_device
    from repro_torch.models.cnn import image_shape
    from repro_torch.models.registry import build_model
    from repro_torch.orchestrator.client_pool import ClientPool, TrainJob
    from repro_torch.utils.pytree import tree_leaves, tree_map
    resolve_device("cuda")              # float32 convolutions, no TF32
    cfg = get_config(name)
    client = AnycostClient(build_model(cfg), shrinking.cnn_shrink_spec(cfg),
                           lr=0.1, batch_size=32)
    dt = getattr(torch, dtype)
    params = tree_map(lambda x: x.to(dt), shrinking.sort_channels(
        build_model(cfg).init(torch.Generator().manual_seed(0), cuda),
        client.spec))
    rng = np.random.default_rng(0)
    task, _ = make_image_task(rng, 256, 8, shape=image_shape(cfg))
    batches = [{"images": torch.tensor(task.x[i], device=cuda, dtype=dt),
                "labels": torch.tensor(task.y[i], device=cuda)}
               for i in rng.permutation(256).reshape(4, 2, 32)]
    sub = shrinking.shrink(params, alpha, client.spec)
    pool = ClientPool(client)
    subs = [tree_map(lambda x, j=j: x * (1.0 - 0.01 * j), sub)
            for j in range(4)]
    for got, starts in (
            (pool.train_shared(params, [TrainJob(j, alpha, b)
                                        for j, b in enumerate(batches)]),
             [sub] * 4),
            (pool.train_stacked([TrainJob(j, alpha, b, sub_params=s)
                                 for j, (b, s) in enumerate(zip(batches,
                                                                subs))]),
             subs)):
        for g, s, b in zip(got, starts, batches):
            for x, y in zip(tree_leaves(g),
                            tree_leaves(client._local_steps(s, b))):
                assert x.device.type == "cuda"
                torch.testing.assert_close(
                    x, y, rtol=1e-5, atol=1e-5 * float(y.abs().max()))


@pytest.mark.parametrize("name", ["fmnist-cnn", "vgg9-cifar"])
def test_lane_bytes_bounds_what_a_group_holds_on_the_card(cuda, name):
    """What a pooled group of 8 full-width lanes, 2 steps of 32 images,
    adds to the card's peak above its jobs' inputs is at most
    ``cnn_lanes.lane_bytes`` a lane, and more than half of it: the pool's
    runs fit the memory and are not cut far shorter than they need."""
    from repro_torch.configs import get_config
    from repro_torch.core import shrinking
    from repro_torch.core.anycost import AnycostClient
    from repro_torch.device import resolve_device
    from repro_torch.models import cnn_lanes
    from repro_torch.models.cnn import image_shape
    from repro_torch.models.registry import build_model
    from repro_torch.orchestrator.client_pool import ClientPool, TrainJob
    resolve_device("cuda")
    cfg = get_config(name)
    client = AnycostClient(build_model(cfg), shrinking.cnn_shrink_spec(cfg),
                           lr=0.1, batch_size=32)
    params = shrinking.sort_channels(build_model(cfg).init(
        torch.Generator().manual_seed(0), cuda), client.spec)
    gen = torch.Generator(device=cuda).manual_seed(0)
    batches = [{"images": torch.rand(2, 32, *image_shape(cfg),
                                     generator=gen, device=cuda),
                "labels": torch.randint(0, cfg.vocab_size, (2, 32),
                                        generator=gen, device=cuda)}
               for _ in range(8)]
    pool = ClientPool(client)
    pool.train_shared(params, [TrainJob(j, 1.0, b)
                               for j, b in enumerate(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pool.train_shared(params, [TrainJob(j, 1.0, b)
                               for j, b in enumerate(batches)])
    torch.cuda.synchronize()
    held = (torch.cuda.max_memory_allocated() - base) / 8
    est = cnn_lanes.lane_bytes(params, batches[0]["images"])
    assert held <= est < 2 * held, (held, est)


@pytest.mark.parametrize("policy", ["sync_pooled", "semisync", "fedbuff"])
def test_async_paths_launch_their_kernels(cuda, policy):
    """Phase 7's paths at 3 devices: a pooled sync or semisync round
    compresses every trained update (accepted or dropped: the norms and
    #5 once each) and aggregates with #6 once per round with accepted
    updates; a fedbuff merge compresses and absorbs (#7) each buffered
    update and launches no #6 or #8."""
    from repro_torch.orchestrator.policies import OrchestratorConfig
    from repro_torch.orchestrator.runner import run_orchestrated
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig
    orch = {"sync_pooled": OrchestratorConfig(use_pool=True),
            "semisync": OrchestratorConfig(policy="semisync",
                                           deadline_s=10.5),
            "fedbuff": OrchestratorConfig(policy="fedbuff", buffer_size=2,
                                          max_wallclock_s=30.0)}[policy]
    ops.reset_launch_counts()
    hist = run_orchestrated(FLRunConfig(rounds=2, n_train=128, n_test=64,
                                        eval_every=1, lr=0.1, seed=3,
                                        use_planner=False),
                            FleetConfig(n_devices=3), orch, device="cuda")
    counts = ops.launch_counts()
    trained = sum(r.n_clients + r.n_dropped for r in hist.rounds)
    assert trained > 0
    assert counts["kernel_l2"] == counts["kernel_sumsq"] == trained
    assert counts["fused_sparsify_quantize"] == trained
    assert counts["threshold_apply"] == counts["prob_quantize"] == 0
    assert counts["aio_merge"] == 0
    if policy == "fedbuff":
        assert counts["aio_absorb"] == trained
        assert counts["aio_aggregate"] == 0
        assert len(hist.rounds) >= 2 and hist.peak_inflight == 3
    else:
        assert counts["aio_absorb"] == 0
        assert counts["aio_aggregate"] == sum(r.n_clients > 0
                                              for r in hist.rounds)
    if policy == "semisync":
        assert sum(r.n_dropped for r in hist.rounds) > 0
    assert np.isfinite(hist.rounds[-1].test_loss)


@pytest.mark.parametrize("path", ["dynamic_flat", "mobile_hier"])
def test_fleet_paths_launch_their_kernels(cuda, path):
    """A dynamic flat fleet (Markov availability, a battery, gain
    selection at 0.5) and a mobile 2-cell hierarchy (random waypoint,
    nearest handover) on the card: every trained update is compressed
    (the norms and #5 once each), an aborted flight never; the flat run
    aggregates with #6 once per round with accepted updates, the
    hierarchical one absorbs each accepted update (#7) and merges each
    extra reporting cell (#8)."""
    from repro_torch.fleet import (AvailabilityConfig, BatteryConfig,
                                   FleetDynamicsConfig)
    from repro_torch.mobility import HandoverConfig, MobilityConfig
    from repro_torch.orchestrator.runner import run_orchestrated
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.topology import TopologyConfig
    from repro_torch.train.fl_loop import FLRunConfig
    fleet = {
        "dynamic_flat": FleetConfig(n_devices=4, dynamics=FleetDynamicsConfig(
            availability=AvailabilityConfig(kind="markov", seed=1),
            battery=BatteryConfig(capacity_j=30.0, recharge_w=0.2),
            selection="gain", participation=0.5)),
        "mobile_hier": FleetConfig(n_devices=4, topology=TopologyConfig(
            kind="hier", n_cells=2, handover=HandoverConfig(margin_m=5.0)),
            mobility=MobilityConfig(kind="random_waypoint", seed=9,
                                    speed_range=(30.0, 60.0)))}[path]
    ops.reset_launch_counts()
    hist = run_orchestrated(FLRunConfig(rounds=2, n_train=128, n_test=64,
                                        eval_every=1, lr=0.1, seed=3,
                                        use_planner=False),
                            fleet, None, device="cuda")
    counts = ops.launch_counts()
    trained = sum(r.n_clients + r.n_dropped for r in hist.rounds)
    accepted = sum(r.n_clients for r in hist.rounds)
    assert trained > 0
    assert counts["kernel_l2"] == counts["kernel_sumsq"] == trained
    assert counts["fused_sparsify_quantize"] == trained
    assert counts["threshold_apply"] == counts["prob_quantize"] == 0
    if path == "dynamic_flat":
        assert sum(r.n_aborted + r.n_unavailable for r in hist.rounds) > 0
        assert counts["aio_aggregate"] == sum(r.n_clients > 0
                                              for r in hist.rounds)
        assert counts["aio_absorb"] == counts["aio_merge"] == 0
    else:
        assert hist.total_handovers() > 0
        assert sum(e[2] == "handover" for e in hist.trace) == \
            hist.total_handovers()
        assert counts["aio_absorb"] == accepted
        assert counts["aio_merge"] == sum(r.n_cells_reporting - 1
                                          for r in hist.rounds)
        assert counts["aio_aggregate"] == 0
    assert all(np.isfinite(r.test_loss) for r in hist.rounds
               if r.test_loss is not None)


def test_telemetry_on_the_card_is_invisible_and_launches_alike(cuda):
    """A 3-device flat run with a telemetry session (and the health
    engine) on the card against the same run without one: every
    ``RoundLog`` field, the event trace and the final parameters bitwise
    equal and every kernel launched as often.  Both run on cuDNN's
    deterministic algorithms: under the default ones two runs of one
    configuration need not agree bit for bit on the card."""
    import dataclasses

    from repro_torch import telemetry
    from repro_torch.sysmodel.population import FleetConfig
    from repro_torch.train.fl_loop import FLRunConfig, run_fl
    from repro_torch.utils.pytree import tree_leaves
    cfg = FLRunConfig(rounds=2, n_train=128, n_test=32, eval_every=1, seed=3)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {}
        for on in (False, True):
            tel = None
            if on:
                tel = telemetry.Telemetry()
                tel.health = telemetry.HealthEngine(telemetry.DEFAULT_RULES)
            ops.reset_launch_counts()
            hist = run_fl(cfg, FleetConfig(n_devices=3), device="cuda",
                          telemetry=tel)
            out[on] = (hist, ops.launch_counts(), tel)
    finally:
        torch.backends.cudnn.deterministic = saved
    (off, c_off, _), (on, c_on, tel) = out[False], out[True]
    assert c_on == c_off and c_on["aio_aggregate"] == 2
    assert [dataclasses.asdict(r) for r in on.rounds] == \
        [dataclasses.asdict(r) for r in off.rounds]
    assert on.trace == off.trace
    for a, b in zip(tree_leaves(on.final_params),
                    tree_leaves(off.final_params)):
        assert a.is_cuda and torch.equal(a, b)
    assert tel.registry.value("learning.update_norm", device=0,
                              round=0) > 0


@pytest.mark.parametrize("arch,kw", [
    ("qwen2-7b", {}),
    ("qwen2-7b", dict(n_heads=8, n_kv_heads=2, head_dim=32)),
    ("granite-moe-1b-a400m", {}),
    ("pixtral-12b", {})])
def test_serving_on_the_card_matches_the_cpu(cuda, arch, kw):
    """A reduced float32 model initialised once on the CPU and copied to
    the card: prefill (B=2, 12 tokens) and 4 decode steps teacher-forced
    with the CPU's greedy tokens; logits and caches within rtol/atol 1e-4
    (TF32 is off), ``k_pos`` exact."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as T
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_map
    resolve_device("cuda")
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), cpu)
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)), dtype=torch.int32)
    cl, cc = T.prefill_lm(cpu, toks, cfg, 16)
    gl, gc = T.prefill_lm(card, toks.to(cuda), cfg, 16)
    for _ in range(4):
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
        tok = cl[:, -1:].argmax(-1).to(torch.int32)
        cl, cc = model.decode(cpu, cc, {"tokens": tok})
        gl, gc = model.decode(card, gc, {"tokens": tok.to(cuda)})
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    assert torch.equal(gc["blocks"]["k_pos"].cpu(), cc["blocks"]["k_pos"])
    for k in ("k", "v"):
        torch.testing.assert_close(gc["blocks"][k].cpu(), cc["blocks"][k],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window", [None, 300])
@pytest.mark.parametrize("causal_skip", [False, True])
def test_blockwise_attention_on_the_card_matches_dense(cuda, window,
                                                       causal_skip):
    """qwen2-7b's head shapes (28 q-heads over 4 kv-heads, head_dim 128),
    float32, B=1, S=1024 in blocks of 256: within the reference's 2e-5
    of the dense path."""
    from repro_torch.device import resolve_device
    from repro_torch.models import attention
    resolve_device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(0)
    S = 1024
    q = torch.randn((1, S, 28, 128), generator=gen, device=cuda)
    k = torch.randn((1, S, 4, 128), generator=gen, device=cuda)
    v = torch.randn((1, S, 4, 128), generator=gen, device=cuda)
    pos = torch.arange(S, device=cuda)
    want = attention.attention_dense(q, k, v, pos, pos, window=window)
    got = attention.attention_blockwise(q, k, v, pos, pos, window=window,
                                        block_q=256, block_kv=256,
                                        causal_skip=causal_skip)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("arch,kw,S", [
    ("falcon-mamba-7b", {}, 256), ("recurrentgemma-9b", {"n_layers": 5}, 80),
    ("seamless-m4t-large-v2", {}, 16)])
def test_recurrent_and_encdec_serving_on_the_card_match_the_cpu(cuda, arch,
                                                                kw, S):
    """Reduced float32 models: the forward, the serve path's decode-loop
    prefill and 4 decode steps teacher-forced with the CPU's tokens, card
    against CPU at rtol/atol 1e-4 (the SSM over two scan chunks, the
    hybrid's attention ring wrapped); every cache leaf too, positions
    exact."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.serve import prefill_into_cache
    from repro_torch.models.registry import build_model
    from repro_torch.utils.pytree import tree_leaves, tree_map
    resolve_device("cuda")
    cfg = dataclasses.replace(get_config(arch).reduced(), **kw)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), cpu)
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab_size, (2, S)),
                                    dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(rng.standard_normal(
            (2, cfg.encdec.n_frames, cfg.d_model)), dtype=torch.float32)
    torch.testing.assert_close(
        model.forward(card, {k: v.to(cuda) for k, v in batch.items()}).cpu(),
        model.forward(cpu, batch), rtol=1e-4, atol=1e-4)
    toks = batch["tokens"]
    cl, cc = prefill_into_cache(model, cpu, toks, S + 4)
    gl, gc = prefill_into_cache(model, card, toks.to(cuda), S + 4)
    for _ in range(4):
        torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
        tok = cl[:, -1:].argmax(-1).to(torch.int32)
        cl, cc = model.decode(cpu, cc, {"tokens": tok})
        gl, gc = model.decode(card, gc, {"tokens": tok.to(cuda)})
    torch.testing.assert_close(gl.cpu(), cl, rtol=1e-4, atol=1e-4)
    assert gc["pos"] == cc["pos"] == S + 4
    gc.pop("pos"), cc.pop("pos")
    for g, c in zip(tree_leaves(gc), tree_leaves(cc)):
        if c.dtype == torch.int32:
            assert torch.equal(g.cpu(), c)
        else:
            torch.testing.assert_close(g.cpu(), c, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-moe-1b-a400m",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "pixtral-12b", "seamless-m4t-large-v2"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced float32 model initialised once on the CPU and copied to
    the card, one batch (B=2, S=32): the loss within 1e-4 and every
    gradient leaf within 1e-4 of the leaf's largest |g|; then one
    ``make_train_step`` AdamW step (lr 3e-4 at step 1 under warmup 10)
    on each, the loss within 1e-4 and every parameter within 2 lr."""
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step, value_and_grad
    from repro_torch.launch.train import _modality_extras
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import adamw
    from repro_torch.utils.pytree import tree_leaves, tree_map
    resolve_device("cuda")
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), cpu)
    batch = {"tokens": torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)), dtype=torch.int32)}
    batch.update(_modality_extras(cfg, 2, 32, "cpu"))
    gbatch = {k: v.to(cuda) for k, v in batch.items()}
    cl, cg = value_and_grad(model, cpu, batch, remat="full")
    gl, gg = value_and_grad(model, card, gbatch, remat="full")
    assert abs(float(gl) - float(cl)) <= 1e-4
    for a, b in zip(tree_leaves(gg), tree_leaves(cg)):
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * float(
            b.abs().max())
    opt = adamw(3e-3, warmup=10)
    step = make_train_step(model, opt, remat="full")
    cpu, _, cl = step(cpu, opt.init(cpu), batch)
    card, state, gl = step(card, opt.init(card), gbatch)
    assert abs(float(gl) - float(cl)) <= 1e-4
    assert state["step"].device.type == "cuda"
    for a, b in zip(tree_leaves(card), tree_leaves(cpu)):
        assert float((a.cpu() - b).abs().max()) <= 2 * 3e-4 * 1.001


def test_pod_sync_and_cell_fold_on_the_card_launch_their_kernels(cuda,
                                                                  tmp_path):
    """One pod in a one-rank gloo group (which carries CUDA tensors): the
    compressed sync of a 3-leaf tree launches #6 once a leaf and equals,
    bit for bit, each pod's compression followed by the plain Eq. 5 with
    unit weights on the card; ``mesh_cell_aggregate`` over 6 rows
    launches #7 six times and lies within the reference's 1e-5 of the
    stacked Eq. 5."""
    import torch.distributed as dist
    from repro_torch.core import distributed
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        gen = torch.Generator(device=cuda).manual_seed(3)
        grads = {"a": torch.randn(4096, generator=gen, device=cuda),
                 "b": torch.randn(96, 128, generator=gen, device=cuda),
                 "c": torch.randn(7, generator=gen, device=cuda)}
        for keep, quant in ((1.0 / 16.0, True), (0.25, False), (1.0, True)):
            want = {}
            for k, g in grads.items():
                kept, payload, scale = distributed._local_compress(
                    g, keep, quant)
                u = payload.float() * scale if quant else payload
                m = kept.float() if keep < 1.0 else torch.ones_like(u)
                want[k] = ref.aio_aggregate_ref(
                    u.reshape(1, -1), m.reshape(1, -1),
                    torch.ones(1, device=cuda)).view(g.shape)
            ops.reset_launch_counts()
            got = distributed.anycost_gradient_sync(
                {k: v.clone() for k, v in grads.items()}, "pod",
                keep_frac=keep, quantize=quant)
            torch.cuda.synchronize()
            assert ops.launch_counts()["aio_aggregate"] == len(grads)
            for k in grads:
                assert torch.equal(got[k], want[k])
        u = torch.randn(6, 5000, generator=gen, device=cuda)
        m = (torch.rand(6, 5000, generator=gen, device=cuda) > 0.4).float()
        w = torch.rand(6, generator=gen, device=cuda) + 0.5
        ops.reset_launch_counts()
        agg = distributed.mesh_cell_aggregate(u, m, w)
        torch.cuda.synchronize()
        assert ops.launch_counts()["aio_absorb"] == 6
        torch.testing.assert_close(agg, ref.aio_aggregate_ref(u, m, w),
                                   rtol=0, atol=1e-5)
    finally:
        dist.destroy_process_group()
