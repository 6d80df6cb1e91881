"""The port's kernels on the CPU: plain PyTorch versions against the JAX
oracles and the Pallas kernels (interpret mode), and the dispatch rules.
The CUDA kernels themselves are held against the plain versions on a
card, in ``tests/test_torch_cuda.py``.

Inputs are made with a seeded numpy generator and handed to both sides.
Tolerances: masks and level indices exact; values rtol 1e-6 (float32
sums taken in another order), bits and norms as stated per test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import aio_agg as jax_aio  # noqa: E402
from repro.kernels import fused_compress as jax_fused  # noqa: E402
from repro.kernels import quantize as jax_quant  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro.kernels import sparsify as jax_sparsify  # noqa: E402
from repro_torch.core import compression  # noqa: E402
from repro_torch.kernels import (aio_agg, build, fused_compress,  # noqa: E402
                                 grouped_mm, ops, quantize, ref,
                                 sparsify)

torch.set_num_threads(1)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.tensor(np.asarray(a))


def _quant_inputs(rng, K, C):
    x = rng.standard_normal((K, C)).astype(np.float32)
    rand = rng.uniform(size=(K, C)).astype(np.float32)
    norms = np.sqrt((x.astype(np.float32) ** 2).sum(1)).astype(np.float32)
    thr = np.float32(np.median(norms))
    keep = norms >= thr
    av = np.abs(x) * keep[:, None]
    u_min = np.float32(av[av > 0].min())
    u_max = np.float32(av.max())
    return x, rand, norms, thr, u_min, u_max


def test_oracle_table_mirrors_reference():
    assert set(ref.ORACLES) == set(jax_ref.ORACLES)


@pytest.mark.parametrize("K,C", [(8, 128), (100, 700), (33, 1000),
                                 (1000, 9), (512, 3136)])
def test_kernel_sumsq_and_l2(K, C):
    x = _rng(K).standard_normal((K, C)).astype(np.float32)
    for port_fn, oracle, pallas in (
            (ref.kernel_sumsq_ref, jax_ref.kernel_sumsq_ref,
             jax_sparsify.kernel_sumsq),
            (ref.kernel_l2_ref, jax_ref.kernel_l2_ref,
             jax_sparsify.kernel_l2)):
        got = port_fn(_t(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(oracle(jnp.asarray(x))),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            got, np.asarray(pallas(jnp.asarray(x), interpret=True)),
            rtol=1e-6)


def test_kernel_l2_op_takes_the_transposed_leaf_view():
    """The main path's (K, ksize) view with strides (1, K) gives the
    norms of a contiguous copy (rtol 1e-6: torch sums a strided view in
    another order)."""
    leaf = torch.tensor(_rng(1).standard_normal((5, 5, 4, 8))
                        .astype(np.float32))
    view = leaf.reshape(-1, 8).t()
    assert view.stride() == (1, 8)
    np.testing.assert_allclose(ops.kernel_l2_op(view).numpy(),
                               ops.kernel_l2_op(view.contiguous()).numpy(),
                               rtol=1e-6)


#: the fmnist-cnn update's leaves, in sorted-key order
FMNIST_SHAPES = [(32,), (5, 5, 1, 32), (64,), (5, 5, 32, 64), (512,),
                 (3136, 512), (10,), (512, 10)]
#: small updates with 1-D leaves, a one-element leaf and ragged K (not a
#: multiple of the 32-kernel tile) and C (not of the 256-column tile)
SMALL_SHAPE_LISTS = [
    [(6,), (3, 3, 2, 6), (17,), (24, 10)],
    [(5, 5, 1, 32), (32,), (40, 33), (1,)],
    [(7,), (300, 70), (70,)],
]


def _emulate_norm_kernel(base, table, take_sqrt):
    """The two passes of ``csrc/sparsify.cu``'s norm kernel, over the
    table's rows, in numpy: tiles of 32 kernels x 256 columns write
    partial sums, then each kernel's partials are added in chunk order.
    Returns (norms, how often each element of ``base`` was read)."""
    rows = table.rows
    reads = np.zeros(base.size, np.int64)
    part = np.full(table.n_partials, np.nan)

    def segment(i, field):          # the kernel's linear scan
        s = 0
        while s + 1 < len(rows) and i >= rows[s + 1][field]:
            s += 1
        return rows[s]

    for b in range(table.n_tiles):
        off, K, C, sK, sC, _, tile0, part0, ktiles = segment(b, 6)
        kt, ct = (b - tile0) % ktiles, (b - tile0) // ktiles
        ks = np.arange(kt * sparsify.TILE_ROWS,
                       min((kt + 1) * sparsify.TILE_ROWS, K))
        cs = np.arange(ct * sparsify.TILE_CHUNK,
                       min((ct + 1) * sparsify.TILE_CHUNK, C))
        idx = off + ks[:, None] * sK + cs[None, :] * sC
        np.add.at(reads, idx.reshape(-1), 1)
        part[part0 + ct * K + ks] = (base[idx].astype(np.float64) ** 2).sum(1)
    out = np.zeros(table.k_total)
    for i in range(table.k_total):
        _, K, C, _, _, out0, _, part0, _ = segment(i, 5)
        chunks = -(-C // sparsify.TILE_CHUNK)
        out[i] = sum(part[part0 + ch * K + i - out0] for ch in range(chunks))
    return (np.sqrt(out) if take_sqrt else out), reads


def test_segment_table_of_the_fmnist_update():
    """8 segments, one per leaf, whose element ranges tile N; K_total 622;
    the (3136, 512) dense leaf alone spans more tiles than the H100 has
    SMs; the table is cached per tuple of shapes."""
    table = sparsify.flat_table(tuple(FMNIST_SHAPES))
    assert sparsify.flat_table(tuple(FMNIST_SHAPES)) is table
    assert len(table.rows) == 8
    assert table.k_total == 622 and table.n_elements == 1_663_370
    end = 0
    for (off, K, C, sK, sC, *_), shape in zip(table.rows, FMNIST_SHAPES):
        assert off == end and (K, C) == compression.leaf_kernel_shape(shape)
        assert (sK, sC) == (1, K)
        end += K * C
    assert end == 1_663_370
    dense = table.rows[5]
    dense_tiles = table.rows[6][6] - dense[6]
    assert (dense[1], dense[2]) == (512, 3136) and dense_tiles >= 132
    assert len(table.blob) == 8 * 9 * 8


@pytest.mark.parametrize("shapes", [FMNIST_SHAPES, *SMALL_SHAPE_LISTS])
def test_segment_table_reads_every_element_once(shapes):
    """Emulated over its table, the kernel reads each element of the flat
    update exactly once and gives the plain version's norms."""
    n = sum(int(np.prod(s)) for s in shapes)
    vec = _rng(n).standard_normal(n).astype(np.float32)
    table = sparsify.flat_table(tuple(shapes))
    got, reads = _emulate_norm_kernel(vec, table, take_sqrt=True)
    assert (reads == 1).all()
    np.testing.assert_allclose(
        got, ref.kernel_l2_flat_ref(_t(vec), shapes).numpy(), rtol=1e-5)


@pytest.mark.parametrize("layout", ["row-major", "transposed"])
def test_segment_table_of_a_single_view(layout):
    """A single (K, ksize) view with any strides is a one-segment table
    over the view's own first element."""
    base = _rng(7).standard_normal(70 * 300).astype(np.float32)
    x = _t(base).view(70, 300) if layout == "row-major" \
        else _t(base).view(300, 70).t()
    table = sparsify._view_table(*x.shape, *x.stride())
    assert table.rows == ((0, 70, 300, *x.stride(), 0, 0, 0, 3),)
    assert table.n_tiles == 3 * 2 and table.n_partials == 2 * 70
    got, reads = _emulate_norm_kernel(base, table, take_sqrt=False)
    assert (reads == 1).all()
    np.testing.assert_allclose(got, ref.kernel_sumsq_ref(x).numpy(),
                               rtol=1e-5)


def test_segment_table_cap():
    """At most MAX_SEGMENTS segments ride in the launch; the largest model
    config of the port (vgg9-cifar) fits under the cap."""
    from repro_torch.configs.vgg9_cifar import CONFIG
    from repro_torch.models.cnn import init_vgg9
    from repro_torch.utils.pytree import tree_leaves
    cap = sparsify.MAX_SEGMENTS
    assert len(sparsify.flat_table(((3,),) * cap).rows) == cap
    with pytest.raises(ValueError, match="segments"):
        sparsify.flat_table(((3,),) * (cap + 1))
    with pytest.raises(ValueError, match="segments"):
        sparsify.segment_table(())
    leaves = tree_leaves(init_vgg9(torch.Generator().manual_seed(0), CONFIG))
    shapes = tuple(tuple(x.shape) for x in leaves)
    assert len(sparsify.flat_table(shapes).rows) == len(leaves) <= cap


@pytest.mark.parametrize("shapes", SMALL_SHAPE_LISTS)
def test_flat_norms_match_the_pallas_kernel_per_leaf(shapes):
    """The flat entries' plain versions (the L2 one through its CPU
    dispatch) against the JAX package's Pallas kernels (interpret mode),
    one call per leaf view, concatenated."""
    n = sum(int(np.prod(s)) for s in shapes)
    vec = _rng(n + 1).standard_normal(n).astype(np.float32)
    leaves, off = [], 0
    for s in shapes:
        K, C = compression.leaf_kernel_shape(s)
        leaves.append(jnp.asarray(vec[off:off + K * C].reshape(C, K).T))
        off += K * C
    for op, pallas in ((ref.kernel_sumsq_flat_ref, jax_sparsify.kernel_sumsq),
                       (ops.kernel_l2_flat_op, jax_sparsify.kernel_l2)):
        want = np.concatenate([np.asarray(pallas(x, interpret=True))
                               for x in leaves])
        np.testing.assert_allclose(op(_t(vec), shapes).numpy(), want,
                                   rtol=1e-6)


@pytest.mark.parametrize("shapes", SMALL_SHAPE_LISTS)
def test_norms_match_reference_kernel_norms(shapes):
    """compression._norms (the flat entry) against the reference's
    segment-sum ``core/compression.kernel_norms`` (rtol 1e-5: the two sum
    in another order)."""
    from repro.core import compression as jcomp
    tree = {f"l{i}": jnp.zeros(s, jnp.float32) for i, s in enumerate(shapes)}
    seg, K = jcomp.kernel_segments(tree)
    n = seg.size
    vec = _rng(n + 2).standard_normal(n).astype(np.float32)
    want = np.asarray(jcomp.kernel_norms(jnp.asarray(vec), seg, K))
    # the reference walks leaves in sorted-key order: l0, l1, ... for < 10
    got = compression._norms(_t(vec), list(shapes))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def _emulate_fused_kernel_ids(table, n):
    """The norm index ``csrc/fused_compress.cu`` gives each storage offset
    of ``[0, n)``: the last segment whose offset is at or below it, then
    ``j % K`` (kernel-fastest, sK == 1) or ``j / sK`` (row-major), as the C
    entry derives them from the table's rows."""
    rows = np.asarray(table.rows, np.int64)
    p = np.arange(n, dtype=np.int64)
    s = np.searchsorted(rows[:, 0], p, side="right") - 1
    off, K, sK, out_base = rows[s, 0], rows[s, 1], rows[s, 3], rows[s, 5]
    j = p - off
    div = np.maximum(np.where(sK == 1, K, sK), 1)
    return out_base + np.where(sK == 1, j % div, j // div)


@pytest.mark.parametrize("shapes", [FMNIST_SHAPES, *SMALL_SHAPE_LISTS])
def test_fused_table_maps_every_element_to_its_kernel(shapes):
    """The flat fused call's table: the leaves' segments tile the update,
    each element once, and the kernel's element map gives each element the
    kernel id of ``compression.kernel_segments``."""
    table = sparsify.flat_table(tuple(shapes))
    n = sum(int(np.prod(s)) for s in shapes)
    covered = np.zeros(n, np.int64)
    for off, K, C, *_ in table.rows:
        covered[off:off + K * C] += 1
    assert (covered == 1).all() and table.n_elements == n
    tree = {f"l{i:02d}": torch.zeros(s) for i, s in enumerate(shapes)}
    seg, k_total = compression.kernel_segments(tree)
    assert k_total == table.k_total
    np.testing.assert_array_equal(_emulate_fused_kernel_ids(table, n), seg)


@pytest.mark.parametrize("K,C", [(70, 300), (1, 9), (9, 1)])
@pytest.mark.parametrize("fastest", [True, False])
def test_fused_view_table_maps_storage_to_rows(K, C, fastest):
    """A single dense view is a one-segment table: each storage offset
    maps to its element's row, in either layout."""
    table = sparsify._view_table(K, C, *((1, K) if fastest else (C, 1)))
    rows = torch.arange(K)[:, None].expand(K, C)
    storage = rows.t().reshape(-1) if fastest else rows.reshape(-1)
    np.testing.assert_array_equal(_emulate_fused_kernel_ids(table, K * C),
                                  storage.numpy())


@pytest.mark.parametrize("levels", [2.0, 64.0, 37.25])
@pytest.mark.parametrize("shapes", SMALL_SHAPE_LISTS)
def test_flat_fused_matches_the_pallas_kernel_per_leaf(shapes, levels):
    """The flat fused call's plain version and its CPU dispatch against the
    JAX package's Pallas kernel (interpret mode) run on each leaf's
    ``(K, ksize)`` view and laid back out flat: levels exact, values rtol
    1e-6."""
    n = sum(int(np.prod(s)) for s in shapes)
    rng = _rng(n + 3)
    vec = rng.standard_normal(n).astype(np.float32)
    rand = rng.uniform(size=n).astype(np.float32)
    norms = ref.kernel_l2_flat_ref(_t(vec), shapes).numpy()
    thr = np.float32(np.median(norms))
    seg, _ = compression.kernel_segments(
        {f"l{i:02d}": torch.zeros(s) for i, s in enumerate(shapes)})
    av = np.abs(vec) * (norms >= thr)[seg]
    u_min, u_max = np.float32(av[av > 0].min()), np.float32(av.max())
    want_q, want_l, off, k0 = [], [], 0, 0
    for s in shapes:
        K, C = compression.leaf_kernel_shape(s)
        x = jnp.asarray(vec[off:off + K * C].reshape(C, K).T)
        r = jnp.asarray(rand[off:off + K * C].reshape(C, K).T)
        q, lvl = jax_fused.fused_sparsify_quantize(
            x, jnp.asarray(norms[k0:k0 + K]), jnp.float32(thr),
            jnp.float32(u_min), jnp.float32(u_max), jnp.float32(levels), r,
            interpret=True)
        want_q.append(np.asarray(q).T.reshape(-1))
        want_l.append(np.asarray(lvl).T.reshape(-1))
        off, k0 = off + K * C, k0 + K
    args = (_t(vec), shapes, _t(norms), float(thr), float(u_min),
            float(u_max), levels, _t(rand))
    for fn in (ref.fused_sparsify_quantize_flat_ref,
               ops.fused_sparsify_quantize_flat_op):
        q, lvl = fn(*args)
        assert q.shape == lvl.shape == (n,) and lvl.dtype == torch.int32
        np.testing.assert_array_equal(lvl.numpy(), np.concatenate(want_l))
        np.testing.assert_allclose(q.numpy(), np.concatenate(want_q),
                                   rtol=1e-6)


@pytest.mark.parametrize("K,C", [(64, 256), (37, 129)])
def test_threshold_apply(K, C):
    x, _, norms, thr, _, _ = _quant_inputs(_rng(K), K, C)
    xo, mo = ref.threshold_mask_ref(_t(x), _t(norms), float(thr))
    xr, mr = jax_ref.threshold_mask_ref(jnp.asarray(x), jnp.asarray(norms),
                                        jnp.float32(thr))
    xp, mp = jax_sparsify.threshold_apply(jnp.asarray(x), jnp.asarray(norms),
                                          jnp.float32(thr), interpret=True)
    for xx, mm in ((xr, mr), (xp, mp)):
        np.testing.assert_array_equal(xo.numpy(), np.asarray(xx))
        np.testing.assert_array_equal(mo.numpy(), np.asarray(mm))
    # the op on the main path's transposed leaf view: the same values, laid
    # out like the view
    xt = _t(np.ascontiguousarray(x.T)).t()
    got, keep = ops.threshold_apply_op(xt, _t(norms), float(thr))
    np.testing.assert_array_equal(got.numpy(), xo.numpy())
    np.testing.assert_array_equal(keep.numpy(), mo.numpy())
    # the planner's flat call on a one-leaf update whose C-order (C, K)
    # buffer is that view: the masked view laid out flat
    got, keep = ops.threshold_apply_flat_op(xt.t().reshape(-1), [(C, K)],
                                            _t(norms), float(thr))
    np.testing.assert_array_equal(got.numpy(), xo.numpy().T.reshape(-1))
    np.testing.assert_array_equal(keep.numpy(), mo.numpy())


@pytest.mark.parametrize("thr_at", ["median", "zero"])
@pytest.mark.parametrize("shapes,dead", [
    ([(6,), (3, 3, 2, 6), (17,), (24, 10)], False),
    ([(5, 5, 1, 32), (32,), (40, 33), (1,)], False),
    ([(7,), (300, 70), (70,)], False),
    ([(6,), (3, 3, 2, 6), (17,), (24, 10)], True),
])
def test_flat_threshold_matches_the_pallas_kernel_per_leaf(shapes, dead,
                                                           thr_at):
    """The planner's flat threshold call (CPU dispatch) and its plain
    version against the JAX package's Pallas ``threshold_apply``
    (interpret mode) run on each leaf's ``(K, ksize)`` view, leaf by leaf,
    exactly: masked values and keep flags.  ``dead`` zeroes one kernel of
    the last leaf (norm 0: dropped at the median, kept at a threshold of
    0, where it stays 0)."""
    n = sum(int(np.prod(s)) for s in shapes)
    vec = _rng(n + 4).standard_normal(n).astype(np.float32)
    if dead:
        K, C = compression.leaf_kernel_shape(shapes[-1])
        vec[n - K * C:].reshape(C, K)[:, 3] = 0.0
    norms = ref.kernel_l2_flat_ref(_t(vec), shapes).numpy()
    assert (norms == 0).any() == dead
    thr = np.float32(np.median(norms) if thr_at == "median" else 0.0)
    want_x, want_keep, off, k0 = [], [], 0, 0
    for s in shapes:
        K, C = compression.leaf_kernel_shape(s)
        xm, keep = jax_sparsify.threshold_apply(
            jnp.asarray(vec[off:off + K * C].reshape(C, K).T),
            jnp.asarray(norms[k0:k0 + K]), jnp.float32(thr), interpret=True)
        want_x.append(np.asarray(xm).T.reshape(-1))
        want_keep.append(np.asarray(keep))
        off, k0 = off + K * C, k0 + K
    for fn in (ops.threshold_apply_flat_op, ref.threshold_apply_flat_ref):
        got, keep = fn(_t(vec), shapes, _t(norms), float(thr))
        assert got.shape == (n,) and keep.shape == (k0,)
        assert keep.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.concatenate(want_x))
        np.testing.assert_array_equal(keep.numpy(),
                                      np.concatenate(want_keep))


@pytest.mark.parametrize("N", [512, 5000])
@pytest.mark.parametrize("levels", [2, 16, 255, 37.25])
def test_prob_quantize(N, levels):
    rng = _rng(N)
    v = rng.standard_normal(N).astype(np.float32)
    mask = (rng.uniform(size=N) > 0.3).astype(np.float32)
    rand = rng.uniform(size=N).astype(np.float32)
    av = np.abs(v) * mask
    u_min, u_max = np.float32(av[av > 0].min()), np.float32(av.max())
    q, lvl = ref.quantize_ref(_t(v), _t(mask), float(u_min), float(u_max),
                              levels, _t(rand))
    qr, lr = jax_ref.quantize_ref(jnp.asarray(v), jnp.asarray(mask),
                                  jnp.float32(u_min), jnp.float32(u_max),
                                  jnp.float32(levels), jnp.asarray(rand))
    qp, lp = jax_quant.prob_quantize(jnp.asarray(v), jnp.asarray(mask),
                                     jnp.float32(u_min), jnp.float32(u_max),
                                     jnp.float32(levels), jnp.asarray(rand),
                                     interpret=True, block_n=512)
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(lr))
    np.testing.assert_array_equal(lvl.numpy(), np.asarray(lp))
    np.testing.assert_allclose(q.numpy(), np.asarray(qr), rtol=1e-6)
    np.testing.assert_allclose(q.numpy(), np.asarray(qp), rtol=1e-6)
    qo, lo = ops.prob_quantize_op(_t(v), _t(mask), float(u_min),
                                  float(u_max), levels, _t(rand))
    assert torch.equal(qo, q) and torch.equal(lo, lvl)


@pytest.mark.parametrize("K,C", [(64, 256), (37, 129), (512, 3136)])
@pytest.mark.parametrize("levels", [2, 64, 4096, 37.25])
def test_fused_sparsify_quantize(K, C, levels):
    x, rand, norms, thr, u_min, u_max = _quant_inputs(_rng(K + C), K, C)
    args = (float(thr), float(u_min), float(u_max), float(levels))
    q, lvl = ref.fused_sparsify_quantize_ref(_t(x), _t(norms), *args[:3],
                                             args[3], _t(rand))
    jargs = (jnp.asarray(x), jnp.asarray(norms), jnp.float32(thr),
             jnp.float32(u_min), jnp.float32(u_max), jnp.float32(levels),
             jnp.asarray(rand))
    qr, lr = jax_ref.fused_sparsify_quantize_ref(*jargs)
    qp, lp = jax_fused.fused_sparsify_quantize(*jargs, interpret=True)
    for qq, ll in ((qr, lr), (qp, lp)):
        np.testing.assert_array_equal(lvl.numpy(), np.asarray(ll))
        np.testing.assert_allclose(q.numpy(), np.asarray(qq), rtol=1e-6)


def test_fused_op_keeps_the_transposed_layout_semantics():
    """The strided (K, ksize) view of a leaf gives what the contiguous
    copy gives."""
    x, rand, norms, thr, u_min, u_max = _quant_inputs(_rng(3), 24, 50)
    xt = _t(np.ascontiguousarray(x.T)).t()
    rt = _t(np.ascontiguousarray(rand.T)).t()
    args = (float(thr), float(u_min), float(u_max), 16.0)
    a = ref.fused_sparsify_quantize_ref(xt, _t(norms), *args, rt)
    b = ref.fused_sparsify_quantize_ref(_t(x), _t(norms), *args, _t(rand))
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())


@pytest.mark.parametrize("I,N", [(2, 512), (7, 3000), (12, 2048), (3, 17)])
def test_aio_aggregate(I, N):
    rng = _rng(I * N)
    u = rng.standard_normal((I, N)).astype(np.float32)
    m = (rng.uniform(size=(I, N)) > 0.5).astype(np.float32)
    w = rng.uniform(size=I).astype(np.float32)
    got = ref.aio_aggregate_ref(_t(u), _t(m), _t(w)).numpy()
    want = np.asarray(jax_ref.aio_aggregate_ref(jnp.asarray(u),
                                                jnp.asarray(m),
                                                jnp.asarray(w)))
    pallas = np.asarray(jax_aio.aio_aggregate(jnp.asarray(u), jnp.asarray(m),
                                              jnp.asarray(w), interpret=True,
                                              block_n=512))
    # atol: float32 cancellation in num where signs mix
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_aio_absorb_and_merge_plain_versions():
    rng = _rng(5)
    num, den, u, m = (rng.standard_normal(300).astype(np.float32)
                      for _ in range(4))
    m = (m > 0).astype(np.float32)
    for got, want in zip(
            ref.aio_absorb_ref(_t(num), _t(den), _t(u), _t(m), 0.37),
            jax_ref.aio_absorb_ref(jnp.asarray(num), jnp.asarray(den),
                                   jnp.asarray(u), jnp.asarray(m), 0.37)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for got, want in zip(
            ref.aio_merge_ref(_t(num), _t(den), _t(u), _t(m)),
            jax_ref.aio_merge_ref(jnp.asarray(num), jnp.asarray(den),
                                  jnp.asarray(u), jnp.asarray(m))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("N", [512, 5000])
def test_aio_absorb_and_merge_against_pallas_and_in_place(N):
    """The plain versions against the interpret-mode Pallas kernels; the
    ops' CPU route computes the same in place.  atol on absorb: float32
    cancellation in num + w*m*u where signs mix (XLA may contract it into
    one FMA)."""
    rng = _rng(5 + N)
    num, den, u, m = (rng.standard_normal(N).astype(np.float32)
                      for _ in range(4))
    m = (m > 0).astype(np.float32)

    def j():     # fresh arrays: the Pallas kernels donate the accumulator
        return [jnp.asarray(a) for a in (num, den, u, m)]

    want_abs = ref.aio_absorb_ref(_t(num), _t(den), _t(u), _t(m), 0.37)
    other = jax_aio.aio_absorb(*j(), jnp.float32(0.37), interpret=True,
                               block_n=512)
    for got, want in zip(want_abs, other):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    want_merge = ref.aio_merge_ref(_t(num), _t(den), _t(u), _t(m))
    other = jax_aio.aio_merge(*j(), interpret=True, block_n=512)
    for got, want in zip(want_merge, other):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for op, extra, want in ((ops.aio_absorb_op, (0.37,), want_abs),
                            (ops.aio_merge_op, (), want_merge)):
        a, b = _t(num), _t(den)
        ptrs = (a.data_ptr(), b.data_ptr())
        assert op(a, b, _t(u), _t(m), *extra) is None
        assert (a.data_ptr(), b.data_ptr()) == ptrs
        assert torch.equal(a, want[0]) and torch.equal(b, want[1])


def test_planner_on_threshold_and_quantize_matches_reference():
    """BetaPlanner.fit runs #3 once per rho, over every leaf in one call,
    and #4 once per (rho, L); its map equals the reference's on a second
    probe (the module test holds the first)."""
    from repro.core import compression as jcomp
    rng = _rng(31)
    shapes = {"conv": (3, 3, 2, 6), "b": (6,), "dense": (24, 10)}
    upd = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
           for k, s in shapes.items()}
    upd["dense"][:, 3] = 0.0          # a dead kernel: its norm is 0
    n = sum(x.size for x in upd.values())
    key = jax.random.PRNGKey(3)
    rand = np.asarray(jax.random.uniform(key, (n,)))
    grids = dict(rho_grid=(0.0, 0.3, 0.8, 0.99),
                 level_grid=(2, 8, 64, 4096))
    jp = jcomp.BetaPlanner.fit({k: jnp.asarray(v) for k, v in upd.items()},
                               key, **grids)
    tp = compression.BetaPlanner.fit({k: _t(v) for k, v in upd.items()},
                                     _t(rand), **grids)
    np.testing.assert_array_equal(tp.rhos, jp.rhos)
    np.testing.assert_array_equal(tp.levels, jp.levels)
    np.testing.assert_allclose(tp.betas, jp.betas, rtol=1e-5)


def test_cpu_route_launches_no_kernel():
    ops.reset_launch_counts()
    x = torch.ones(4, 8)
    v = torch.ones(32)
    ops.kernel_l2_op(x)
    ops.kernel_l2_flat_op(x.reshape(-1), [(4, 8)])
    ops.fused_sparsify_quantize_flat_op(x.reshape(-1), [(4, 8)],
                                        torch.ones(8), 0.5, 0.0, 1.0, 4.0,
                                        x.reshape(-1))
    ops.threshold_apply_op(x, torch.ones(4), 0.5)
    ops.threshold_apply_flat_op(x.reshape(-1), [(4, 8)], torch.ones(8), 0.5)
    ops.prob_quantize_op(v, v, 0.0, 1.0, 4.0, v)
    ops.aio_aggregate_op(x, x, torch.ones(4))
    ops.aio_absorb_op(v.clone(), v.clone(), v, v, 0.5)
    ops.aio_merge_op(v.clone(), v.clone(), v, v)
    ops.grouped_mm_op(x, torch.ones(2, 8, 3),
                      torch.tensor([1, 4], dtype=torch.int32))
    counts = ops.launch_counts()
    # the eight kernels of the reference's table, and the grouped GEMM's
    # launches and sizes
    assert set(counts) == set(ref.ORACLES) | set(grouped_mm.launches)
    assert set(counts.values()) == {0}


def test_operands_off_cpu_and_cuda_raise():
    x = torch.ones(4, 8, device="meta")
    # meta operands alone take the plain version, which gives the shape
    # (the dry-run's trace); operands on more than one device raise
    assert ops.kernel_l2_op(x).device.type == "meta"
    with pytest.raises(ValueError):
        ops.aio_aggregate_op(x, torch.ones(4, 8),
                                                     torch.ones(4))


@pytest.mark.parametrize("call", [
    lambda x: sparsify.kernel_l2(x),
    lambda x: sparsify.kernel_l2_flat(x.reshape(-1), [(4, 8)]),
    lambda x: fused_compress.fused_sparsify_quantize(
        x, torch.ones(4), 0.0, 0.0, 1.0, 2.0, x),
    lambda x: fused_compress.fused_sparsify_quantize_flat(
        x.reshape(-1), [(4, 8)], torch.ones(8), 0.0, 0.0, 1.0, 2.0,
        x.reshape(-1)),
    lambda x: aio_agg.aio_aggregate(x, x, torch.ones(4)),
    lambda x: sparsify.threshold_apply(x, torch.ones(4), 0.5),
    lambda x: sparsify.threshold_apply_flat(x.reshape(-1), [(4, 8)],
                                            torch.ones(8), 0.5),
    lambda x: quantize.prob_quantize(x[0], x[0], 0.0, 1.0, 2.0, x[0]),
    lambda x: aio_agg.aio_absorb(x[0], x[0], x[0], x[0], 0.5),
    lambda x: aio_agg.aio_merge(x[0], x[0], x[0], x[0]),
])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    with pytest.raises(ValueError):
        call(torch.ones(4, 8))


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc()
