"""AnycostFL on the pod: compressed cross-pod gradient synchronization,
on ``torch.distributed``.

The paper compresses each device's uplink before server aggregation.
Across pods the analogue treats each *pod* as a device: per-pod gradients
are FGC-compressed (a magnitude threshold, then int8 amax quantization),
exchanged with ``all_gather`` over the pods, and combined with the AIO
masked mean (Eq. 5).  The reference (``repro/core/distributed.py``)
runs under a named mesh axis; here one rank of a process group is one
pod (or, for :func:`mesh_cell_aggregate`, one edge cell).

How the reference's collectives map:
- The axis name selects a process group: the ``DeviceMesh`` dimension of
  that name when a ``mesh`` is given (``mesh.get_group(axis_name)``), an
  explicit ``group=``, or else the default (world) group.  Without an
  initialised process group every function here raises, as the reference
  raises on an unbound axis name: none of them syncs over a world of one
  silently.
- ``all_gather`` is ``dist.all_gather`` in its list form (the int8
  values, the one-element float32 scales, the int8 keep mask); ``psum``
  is ``dist.all_reduce(SUM)``, ``pmean`` the same over the group size.
- The combine ``where(den > 0, num / max(den, 1), 0)`` over the gathered
  ``(P, N)`` stack is Eq. 5 with unit weights, so it runs as the
  ``aio_aggregate`` kernel (#6) on the card and its plain version on the
  CPU; the values are zero wherever the mask is, and ``den`` counts
  pods, so the two agree bit for bit.

The synced values are written into each gradient leaf in place (the
optimizer updates in place too): at published widths a second tree of
gradients does not fit beside the first.  Each leaf's temporaries are
released before the next leaf starts.

A sharded leaf (a ``DTensor`` of the sharded train step,
``launch/steps.py``) is compressed and exchanged shard-wise, as the
reference pins each leaf to its parameter's sharding (its ``_pin``):
the leaf is first placed as its logical axes say (``axes_tree``; the
gradient already is), then each rank compresses its local shard,
gathers the same shard of every pod over the "pod" group (every pod
holds the same shard index at the same data/model coordinate), combines
them with #6 and writes the result into its shard.  The threshold's sum
of squares and the int8 amax stay leaf-global within a pod, as GSPMD
computes them inside the reference's region: each is reduced over the
mesh dimensions that shard the leaf.
"""
from __future__ import annotations

import functools
import math
from fractions import Fraction
from typing import Any

import numpy as np
import torch

from repro_torch.core import aggregation
from repro_torch.kernels import ops
from repro_torch.topology.edge import EdgeAggregator
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

PyTree = Any
F32 = torch.float32
#: ``jnp.sqrt(2.0)`` in float32
SQRT2_F32 = float(np.float32(math.sqrt(2.0)))


# ------------------------------------------------- the reference's erfinv
#
# ``jax.scipy.special.erfinv`` in float32 is XLA's expansion of
# ``chlo.erf_inv`` (Giles' single-precision approximation) over XLA's own
# ``log1p`` and ``log``, with every multiply feeding an add fused into one
# rounding, as XLA's CPU backend compiles it.  ``torch.special.erfinv``
# differs from it in the last bit for some arguments (1 - 1/16, the
# default keep fraction's, among them), which moves the threshold.  The
# argument is a constant of ``keep_frac``, so the port evaluates the same
# expansion on the host, operation by operation in float32.

_f32 = np.float32

_LOG_P = tuple(_f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _fma(a, b, c) -> np.float32:
    """``a * b + c`` in float32, rounded once (to nearest, ties to
    even)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = _f32(float(exact))
    # float(exact) rounds once to float64 and then once more: look at the
    # neighbours for the float32 nearest the exact value
    cands = (np.nextafter(near, _f32(-np.inf)), near,
             np.nextafter(near, _f32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(np.array(v).view(np.int32)) & 1))


def _horner(x, coeffs) -> np.float32:
    r = _f32(coeffs[0])
    for c in coeffs[1:]:
        r = _fma(r, x, _f32(c))
    return r


def _log_f32(v) -> np.float32:
    """XLA's float32 ``log`` of a positive normal ``v`` (Cephes)."""
    bits = int(np.array(_f32(v)).view(np.int32))
    mant = np.array((bits & ~0x7F800000) | 0x3F000000,
                    np.int32).view(np.float32)[()]
    e = _f32(_f32(1) + _f32((bits >> 23) - 0x7F))
    if mant < _f32(0.707106781186547524):
        e = _f32(e - _f32(1))
        x = _f32(_f32(mant - _f32(1)) + mant)
    else:
        x = _f32(mant - _f32(1))
    x2 = _f32(x * x)
    x3 = _f32(x2 * x)
    y = _fma(_fma(x, _LOG_P[0], _LOG_P[1]), x, _LOG_P[2])
    y1 = _fma(_fma(x, _LOG_P[3], _LOG_P[4]), x, _LOG_P[5])
    y2 = _fma(_fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, _f32(_f32(-2.12194440e-4) * e))
    t = _f32(_fma(_f32(-0.5), x2, x) + y)
    return _fma(_f32(0.693359375), e, t)


def _log1p_f32(x) -> np.float32:
    """XLA's float32 ``log1p``: a rational approximation below sqrt(2)-1
    in magnitude, ``log(1 + x)`` above."""
    x = _f32(x)
    if abs(x) < _f32(0.41421356237309504880):
        x2 = _f32(x * x)
        r = _f32(_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
        return _f32(x + _fma(_f32(-0.5), x2, _f32(_f32(x * x2) * r)))
    return _log_f32(_f32(x + _f32(1)))


@functools.lru_cache(maxsize=None)
def erfinv_f32(x: float) -> float:
    """The reference's float32 ``erfinv(x)`` for ``|x| < 1``, bit for bit
    (its eager call; under ``jax.jit`` XLA folds a constant argument with
    another evaluator)."""
    x = _f32(x)
    w = -_log1p_f32(_f32(x * -x))
    if w < _f32(5):
        coeffs, w = _ERFINV_LT5, _f32(w - _f32(2.5))
    else:
        coeffs, w = _ERFINV_GE5, _f32(_f32(math.sqrt(float(w))) - _f32(3))
    return float(_f32(_horner(w, coeffs) * x))


# ------------------------------------------------------------ the groups

def _group(axis_name: str, mesh=None, group=None):
    """The process group that stands for ``axis_name``: ``group``, else
    the ``mesh`` dimension of that name, else the world group.  Raises
    without an initialised process group."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"unbound axis name {axis_name!r}: no torch.distributed process "
            f"group is initialised (one rank is one {axis_name}); call "
            f"torch.distributed.init_process_group first")
    if group is not None:
        return group
    if mesh is not None:
        return mesh.get_group(axis_name)
    return dist.group.WORLD


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """The ``(P, *t.shape)`` stack of every rank's ``t``, in rank order."""
    dist = torch.distributed
    out = t.new_empty((dist.get_world_size(group),) + tuple(t.shape))
    dist.all_gather(list(out.unbind(0)), t.contiguous(), group=group)
    return out


# ----------------------------------------------------------------- sync

def _no_reduce(x: torch.Tensor, op) -> torch.Tensor:
    return x


def _shard_reducer(g):
    """For a ``DTensor`` leaf, the function that reduces a local 0-d
    value over the mesh dimensions that shard it (in place) and the
    leaf's global element count; for a plain leaf, the identity and its
    own count."""
    if not _is_dtensor(g):
        return _no_reduce, g.numel()
    dist = torch.distributed
    mesh = g.device_mesh
    groups = [mesh.get_group(i) for i, p in enumerate(g.placements)
              if p.is_shard()]

    def reduce(x, op):
        for grp in groups:
            dist.all_reduce(x, op=op, group=grp)
        return x

    return reduce, g.numel()


def _is_dtensor(x) -> bool:
    from repro_torch.sharding import is_dtensor
    return is_dtensor(x)


def magnitude_threshold(g: torch.Tensor, keep_frac: float, *,
                        reduce=_no_reduce, numel: int | None = None
                        ) -> torch.Tensor:
    """Approximate ``keep_frac``-quantile of ``|g|`` from a half-normal
    moment fit: ``std * sqrt(2) * erfinv(1 - keep_frac)``, a float32 0-d
    tensor on ``g``'s device, multiplied left to right as the
    reference's.  For a shard of a leaf, ``reduce`` sums the shards' sums
    of squares and ``numel`` is the leaf's element count."""
    if keep_frac >= 1.0:
        return torch.zeros((), dtype=F32, device=g.device)
    gf = g.to(F32)
    sumsq = reduce(gf.square().sum(), torch.distributed.ReduceOp.SUM)
    std = aggregation.sqrt_f32(sumsq / (numel or gf.numel()) + 1e-30)
    # (1.0 - keep_frac) is taken in float64 and rounded once, as the
    # reference's weakly typed argument
    return std * SQRT2_F32 * erfinv_f32(1.0 - keep_frac)


def _local_compress(g: torch.Tensor, keep_frac: float, quantize: bool, *,
                    reduce=_no_reduce, numel: int | None = None):
    """The local FGC stage on ``g`` in float32: threshold -> keep mask ->
    optional int8 amax quantization.  Returns ``(keep, payload, scale)``:
    the bool keep mask; the int8 levels (``quantize``) or the float32
    sparsified values; the float32 0-d scale, or None.  The dequantized
    wire value is ``payload * scale``.  ``reduce`` and ``numel`` make the
    threshold and the amax a whole leaf's when ``g`` is its shard."""
    gf = g.to(F32)
    thr = magnitude_threshold(gf, keep_frac, reduce=reduce, numel=numel)
    keep = gf.abs() >= thr
    sparse = torch.where(keep, gf, torch.zeros((), dtype=F32,
                                               device=gf.device))
    del gf
    if not quantize:
        return keep, sparse, None
    amax = reduce(sparse.abs().max(), torch.distributed.ReduceOp.MAX)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = sparse.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return keep, q, scale


def _pin(g: torch.Tensor, axes) -> torch.Tensor:
    """A ``DTensor`` leaf placed as its logical ``axes`` say under the
    active sharding context (a no-op when it already is)."""
    from repro_torch import sharding as shd
    if axes is None or not shd.active() or not _is_dtensor(g):
        return g
    return shd.lc(g, axes.names)


def _sync_into(g: torch.Tensor, group, keep_frac: float, quantize: bool,
               want_sent: bool = False):
    """Compress ``g``, exchange, combine, and write the result into ``g``
    (in ``g``'s dtype); a ``DTensor`` shard by shard (module docstring).
    Returns the float32 value this rank put on the wire when
    ``want_sent`` (the EF residual's subtrahend), else None."""
    if _is_dtensor(g):
        from torch.distributed.tensor import DTensor
        reduce, numel = _shard_reducer(g)
        sent = _sync_local(g.to_local(), group, keep_frac, quantize,
                           want_sent, reduce, numel)
        if sent is None:
            return None
        return DTensor.from_local(sent, g.device_mesh, g.placements,
                                  run_check=False, shape=g.shape,
                                  stride=g.stride())
    return _sync_local(g, group, keep_frac, quantize, want_sent)


def _sync_local(g: torch.Tensor, group, keep_frac: float, quantize: bool,
                want_sent: bool, reduce=_no_reduce,
                numel: int | None = None):
    keep, payload, scale = _local_compress(g, keep_frac, quantize,
                                           reduce=reduce, numel=numel)
    sent = None
    if want_sent:
        sent = payload.to(F32) * scale if quantize else payload.clone()
    vals = _all_gather(payload, group).view(-1, g.numel())
    del payload
    n_pods = vals.shape[0]
    if quantize:
        scales = _all_gather(scale.reshape(1), group)
        vals = vals.to(F32).mul_(scales)
        del scales
    if keep_frac >= 1.0:
        # every coordinate is transmitted: the plain mean, no mask on the
        # wire (Eq. 5 with every mask 1 divides by the pod count)
        mask = torch.ones_like(vals)
    else:
        # the mask goes over the wire as int8 ({0, 1} is exact)
        mask = _all_gather(keep.to(torch.int8), group).view(
            n_pods, -1).to(F32)
    del keep
    ones = torch.ones(n_pods, dtype=F32, device=g.device)
    out = ops.aio_aggregate_op(vals, mask, ones)
    del vals, mask
    g.copy_(out.view(g.shape))
    return sent


def anycost_sync_leaf(g: torch.Tensor, axis_name: str = "pod",
                      keep_frac: float = 1.0 / 16.0, quantize: bool = True,
                      axes=None, *, mesh=None, group=None) -> torch.Tensor:
    """Compressed AIO all-reduce of one gradient leaf over the pods,
    written into ``g`` in place and returned.

    The AIO denominator comes from the explicit keep mask, exchanged
    beside the values: a pod whose kept coordinate quantized to zero
    still counts.  ``axes`` (the leaf's ``LogicalAxes``) pins a
    ``DTensor`` leaf to its parameter's placements first (module
    docstring); the pinned leaf is returned."""
    g = _pin(g, axes)
    _sync_into(g, _group(axis_name, mesh, group), keep_frac, quantize)
    return g


def anycost_gradient_sync(grads: PyTree, axis_name: str = "pod", *,
                          keep_frac: float = 1.0 / 16.0,
                          quantize: bool = True, axes_tree: PyTree = None,
                          key=None, mesh=None, group=None) -> PyTree:
    """FGC+AIO compressed mean of per-pod gradients, leaf by leaf, in
    place (see the module docstring); returns the synced tree.
    ``axes_tree`` (the parameters' ``LogicalAxes``) pins each ``DTensor``
    leaf to its parameter's placements under an active sharding context;
    it changes nothing on plain leaves or outside a context, as in the
    reference.  ``key`` is accepted and unused, as in the reference."""
    del key
    grp = _group(axis_name, mesh, group)
    leaves = tree_leaves(grads)
    axes = tree_leaves(axes_tree) if axes_tree is not None \
        else [None] * len(leaves)
    out = []
    for g, ax in zip(leaves, axes):
        g = _pin(g, ax)
        _sync_into(g, grp, keep_frac, quantize)
        out.append(g)
    return tree_unflatten(grads, out)


def mean_gradient_sync(grads: PyTree, axis_name: str = "pod", *,
                       mesh=None, group=None) -> PyTree:
    """The uncompressed baseline: the plain sum over the pods divided by
    their count, in place; returns ``grads``."""
    dist = torch.distributed
    grp = _group(axis_name, mesh, group)
    size = dist.get_world_size(grp)
    for g in tree_leaves(grads):
        # a DTensor leaf: every pod holds the same shard of it
        local = g.to_local() if _is_dtensor(g) else g
        dist.all_reduce(local, op=dist.ReduceOp.SUM, group=grp)
        local.div_(size)
    return grads


# ------------------------------------------------------------ error feedback

def init_error_feedback(params: PyTree) -> PyTree:
    """Float32 zero residuals shaped like ``params`` (EF-SGD): the dropped
    mass of each compressed sync is fed back into the next."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)


def anycost_gradient_sync_ef(grads: PyTree, residual: PyTree,
                             axis_name: str = "pod", *,
                             keep_frac: float = 1.0 / 16.0,
                             quantize: bool = True, axes_tree: PyTree = None,
                             mesh=None, group=None
                             ) -> tuple[PyTree, PyTree]:
    """EF variant: compress ``grad + residual``; the new residual is that
    input less what this pod sent (the dequantized wire value, so the
    int8 rounding error stays in it).  Returns new trees ``(synced,
    residual')``; ``grads`` and ``residual`` are left as they were.
    ``axes_tree`` pins ``DTensor`` leaves as in
    :func:`anycost_gradient_sync`."""
    grp = _group(axis_name, mesh, group)
    leaves = tree_leaves(grads)
    axes = tree_leaves(axes_tree) if axes_tree is not None \
        else [None] * len(leaves)
    synced, new_res = [], []
    for g, r, ax in zip(leaves, tree_leaves(residual), axes):
        corrected = _pin(g, ax).to(F32) + r
        # the dtype round trip the collective sees, as a fresh tensor
        wire = corrected.to(g.dtype, copy=True)
        sent = _sync_into(wire, grp, keep_frac, quantize, want_sent=True)
        synced.append(wire)
        new_res.append(corrected.sub_(sent))
    return tree_unflatten(grads, synced), tree_unflatten(grads, new_res)


# ------------------------------------------------- mesh-mapped edge cells

def _same_stack_everywhere(u: torch.Tensor, w, group) -> None:
    """Raise on every rank unless every rank of ``group`` holds a stack
    of ``u``'s shape with the same coefficients ``w`` (their count, sum
    and position-weighted sum in float64)."""
    dist = torch.distributed
    wt = torch.as_tensor(w, dtype=torch.float64).to(u.device).reshape(-1)
    pos = torch.arange(1, wt.numel() + 1, dtype=torch.float64,
                       device=u.device)
    mine = torch.cat([
        torch.tensor([u.shape[0], u[0].numel(), wt.numel()],
                     dtype=torch.float64, device=u.device),
        torch.stack([wt.sum(), (wt * pos).sum()])])
    every = _all_gather(mine, group)
    if not bool((every == mine).all()):
        rows = [[float(x) for x in r] for r in every.cpu()]
        raise RuntimeError(
            f"mesh_cell_aggregate: the ranks hold different stacks (rows, "
            f"columns, weights, their sum and position-weighted sum, by "
            f"rank: {rows}); every rank must bring the same (I, N) stack")


def mesh_cell_aggregate(u: torch.Tensor, m: torch.Tensor, w, mesh=None, *,
                        axis_name: str = "cell", finalize: bool = True,
                        group=None):
    """Pod-scale hierarchical AIO: edge cells mapped onto ranks.

    ``u``/``m``: the whole ``(I, N)`` stack of updates and masks, the
    same on every rank, ``w``: ``(I,)`` unnormalized coefficients; ``I``
    must be a multiple of the group size.  The reference folds one stack
    in one process; here each rank brings its own, so the ranks first
    compare the stack's shape and a fingerprint of ``w`` and all raise
    if any differs (a rank whose stack diverged would fold misaligned
    blocks into a wrong sum, not an error).  Each rank folds its contiguous
    block of ``I / P`` rows, in row order, into an O(N) ``(num, den)``
    partial with the streaming absorb (#7 on the card), then the partials
    are merged with one ``all_reduce(SUM)`` each: the monoid's merge is
    addition, so the sum is the merge.  ``finalize=True`` returns the
    Eq. 5 ratio ``(N,)``, ``finalize=False`` the merged ``(num, den)``.
    Equal to ``aggregation.aio_aggregate_stacked`` up to float
    reordering."""
    dist = torch.distributed
    grp = _group(axis_name, mesh, group)
    n_ranks = dist.get_world_size(grp)
    n_rows = u.shape[0]
    _same_stack_everywhere(u, w, grp)
    if n_rows % n_ranks:
        raise ValueError(f"mesh_cell_aggregate: {n_rows} rows do not split "
                         f"evenly over {n_ranks} ranks; pad with zero-weight "
                         f"rows")
    block = n_rows // n_ranks
    rank = dist.get_rank(grp)
    w = torch.as_tensor(w, dtype=F32).tolist()
    # this rank is one edge cell: the streaming fold of its rows
    edge = EdgeAggregator(rank, u[0])
    for i in range(rank * block, (rank + 1) * block):
        edge.absorb(u[i].to(F32), m[i].to(F32), w[i])
    part = edge.ship()
    dist.all_reduce(part.num, op=dist.ReduceOp.SUM, group=grp)
    dist.all_reduce(part.den, op=dist.ReduceOp.SUM, group=grp)
    if not finalize:
        return part.num, part.den
    return aggregation.partial_finalize(part)
