"""Logical-axis sharding on ``torch.distributed.tensor`` (DTensor).

The reference (``repro/sharding.py``) maps the logical axis names that
the models put on their parameters (``models.layers.param``) and
activations (``lc``) onto the axes of a device mesh through one rule
table.  The same table and the same translation live here: a spec is a
:class:`PartitionSpec`, one entry a tensor dimension (None, a mesh axis
name, or a tuple of names), entry for entry the reference's; a
:class:`NamedSharding` adds the ``DeviceMesh`` and the spec's DTensor
placements, ``Shard(d)`` on each mesh dimension that splits tensor
dimension ``d`` and ``Replicate()`` on the others.

A tensor dimension split over several mesh axes (``"batch"`` over
``("pod", "data")``) is split major-to-minor in the order its entry lists
them in the reference, and in mesh-dimension order by DTensor: the two
agree only when the entry lists the axes in mesh order, which every
default rule does, and :func:`placements_for` raises otherwise.

The "pod" mesh axis is manual, as the reference's ``"anycost"`` step
makes it with its partial-manual ``shard_map``: a spec may name it, but
DTensor never sees it.  ``DTensor``s live on the sub-mesh of the other
axes (``NamedSharding.mesh``), each pod holding its own; a leaf whose
spec names "pod" is first cut to this pod's contiguous block
(:func:`pod_block`), and what GSPMD would reduce over the pods the train
step reduces over the pod group (``launch/steps.py``).  Splitting a
dimension pod-major and then over "data" is the reference's
major-to-minor split of ``("pod", "data")``.  (DTensor's sharding
propagation over a 3-D mesh, with a dimension split over two of its
axes, also takes minutes an op in torch 2.13.)

Where torch 2.11's DTensor refuses an op the models run, :func:`einsum`
runs the product on the local shards, :func:`split_last` replicates a
dimension before a split its shards do not divide, and :func:`pad` pads
shard by shard; on plain tensors each is the torch op.

Outside a :func:`use_sharding` context everything is the identity: no
spec, no sharding, and :func:`lc` returns its argument.  Inside one,
:func:`lc` redistributes a ``DTensor`` to the placements of its logical
axes (a ``Partial`` sum is reduced on the way) and returns a plain tensor
unchanged: a plain tensor has no layout on the mesh to constrain, and
every rank already holds all of it.  Nothing here runs at import, and
nothing touches a device until a context is entered with a mesh.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Sequence, Union

import torch

MeshAxes = Union[None, str, tuple]

# The reference's default rules for the production mesh (single- or
# multi-pod).  An entry maps a logical axis name to one mesh axis, a tuple
# of mesh axes (the dimension is split over their product), or None
# (replicated).
DEFAULT_RULES: dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": None,          # GQA: kv heads usually < model axis
    "head_dim": None,
    "mlp_act": "model",
    "cache_seq": None,         # "data" for batch=1 long decode
    "frames": None,
    "patches": None,
    "inner_act": "model",      # ssm / rglru inner width
    "state": None,
    "experts_act": "model",    # expert dim of dispatched activations
    "capacity": None,
    "vocab_act": "model",      # logits vocab dim
    # params: "fsdp" is the ZeRO-style axis, "tp" the tensor-parallel axis
    "fsdp": "data",
    "tp": "model",
    "experts": "model",        # expert-parallel param axis
    "expert_in": "data",       # expert ffn input dim: ZeRO-style (train)
    "expert_ff": None,         # expert ffn hidden dim (decode: "data")
    "vocab": "model",          # embedding table rows
    "embed_fsdp": "data",      # embedding table feature dim
    "layers": None,            # stacked-layer leading axis
    "conv": None,
    "classes": None,
    "none": None,
}


class PartitionSpec(tuple):
    """One entry a tensor dimension: None, a mesh axis name, or a tuple of
    mesh axis names; compares with the reference's ``PartitionSpec`` entry
    by entry (``tuple(spec)``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


POD = "pod"


class NamedSharding(NamedTuple):
    mesh: object               # the DTensor mesh: the context's, less "pod"
    spec: PartitionSpec        # over every axis of the context's mesh
    placements: tuple          # one DTensor placement a mesh dimension


class _Ctx:
    """The active context, process-wide rather than a thread's: autograd
    runs a CUDA tensor's backward, and a checkpointed block's recompute
    inside it, on a device thread of its own, which must see the mesh and
    rules the forward pass ran under, or the recompute skips every ``lc``
    and rebuilds its tensors in other placements than the forward's."""

    def __init__(self):
        self.mesh = None
        self.rules: dict[str, MeshAxes] = {}
        self.sizes: dict[str, int] = {}
        # the DTensor mesh (no "pod"), and the rules and sizes without it
        self.dmesh = None
        self.drules: dict[str, MeshAxes] = {}
        self.dsizes: dict[str, int] = {}


_CTX = _Ctx()


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[dict] = None):
    """Activate logical-axis sharding over ``mesh`` (a ``DeviceMesh`` with
    named dimensions, one of them other than "pod") for model code within
    this block; ``rules`` override entries of :data:`DEFAULT_RULES`."""
    fields = ("mesh", "rules", "sizes", "dmesh", "drules", "dsizes")
    prev = tuple(getattr(_CTX, f) for f in fields)
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    sizes = mesh_shape(mesh)
    dnames = tuple(a for a in sizes if a != POD)
    if not dnames:
        raise ValueError("a sharding mesh needs an axis beside \"pod\"")

    # drop mesh axes that this mesh lacks (e.g. "pod" on a single pod)
    def _filter(v: MeshAxes, names) -> MeshAxes:
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in names else None
        t = tuple(a for a in v if a in names)
        return t if t else None

    _CTX.mesh = mesh
    _CTX.rules = {k: _filter(v, sizes) for k, v in merged.items()}
    _CTX.sizes = sizes
    _CTX.dmesh = mesh if len(dnames) == len(sizes) else mesh[dnames]
    _CTX.drules = {k: _filter(v, dnames) for k, v in merged.items()}
    _CTX.dsizes = {a: sizes[a] for a in dnames}
    try:
        yield
    finally:
        for f, v in zip(fields, prev):
            setattr(_CTX, f, v)


def active() -> bool:
    return _CTX.mesh is not None


def spec_for(axes: Sequence[Optional[str]]) -> PartitionSpec:
    """Translate a tuple of logical axis names into a spec; a mesh axis is
    used once, by the first dimension that asks for it."""
    if not active():
        return P()
    return _spec(axes, _CTX.rules)


def _spec(axes, rules) -> PartitionSpec:
    used: set[str] = set()
    parts = []
    for name in axes:
        v = rules.get(name or "none")
        if v is None:
            parts.append(None)
            continue
        vt = (v,) if isinstance(v, str) else tuple(v)
        vt = tuple(a for a in vt if a not in used)
        if not vt:
            parts.append(None)
            continue
        used.update(vt)
        parts.append(vt if len(vt) > 1 else vt[0])
    return P(*parts)


def safe_spec(shape: Sequence[int],
              axes: Sequence[Optional[str]]) -> PartitionSpec:
    """:func:`spec_for`, less the mesh axes that do not divide their
    dimension: the longest prefix of an entry's axes that divides it is
    kept."""
    if not active():
        return P()
    return _safe(shape, axes, _CTX.rules, _CTX.sizes)


def _safe(shape, axes, rules, sizes) -> PartitionSpec:
    raw = _spec(axes, rules)
    parts = []
    for dim, entry in zip(shape, tuple(raw) + (None,) * (len(shape)
                                                         - len(raw))):
        if entry is None:
            parts.append(None)
            continue
        entry_t = (entry,) if isinstance(entry, str) else tuple(entry)
        size = 1
        for a in entry_t:
            size *= sizes.get(a, 1)
        if size == 0 or dim % size != 0:
            kept = ()
            acc = 1
            for a in entry_t:
                if dim % (acc * sizes.get(a, 1)) == 0:
                    acc *= sizes.get(a, 1)
                    kept = kept + (a,)
                else:
                    break
            parts.append(kept if len(kept) > 1
                         else (kept[0] if kept else None))
        else:
            parts.append(entry)
    return P(*parts)


def placements_for(spec: PartitionSpec, sizes: dict[str, int]) -> tuple:
    """The DTensor placements of ``spec`` on a mesh of ``sizes`` (``{axis
    name: size}`` in mesh order, no "pod"): ``Shard(d)`` where tensor
    dimension ``d`` names the mesh axis, else ``Replicate()``; "pod" is
    skipped (module docstring).  A mesh axis of one rank gets
    ``Replicate()`` whatever the spec: its rank holds the whole tensor
    either way, and DTensor's view ops refuse to flatten a dimension of
    size one that is sharded.  Raises when an entry lists its mesh axes
    out of mesh order (module docstring)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh_axes = tuple(sizes)
    order = {a: i for i, a in enumerate(mesh_axes)}
    out = [Replicate()] * len(mesh_axes)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        entry_t = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [order[a] for a in entry_t if a != POD]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry_t} of dimension {d} lists its mesh axes "
                f"out of mesh order {tuple(mesh_axes)}: DTensor would split "
                f"the dimension in another order than the reference")
        for i in idx:
            if sizes[mesh_axes[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def sharding_for(shape: Sequence[int],
                 axes: Sequence[Optional[str]]) -> Optional[NamedSharding]:
    """The mesh, spec and placements of a tensor of ``shape`` with logical
    ``axes``; None outside a context."""
    if not active():
        return None
    spec = safe_spec(shape, axes)
    return NamedSharding(_CTX.dmesh, spec, placements_for(spec, _CTX.dsizes))


def pod_size() -> int:
    """The number of pods of the active mesh (1 without a "pod" axis)."""
    return _CTX.sizes.get(POD, 1) if active() else 1


def pod_group():
    """The process group over the pods of the active mesh, or None when it
    has no "pod" axis of more than one pod."""
    if pod_size() <= 1:
        return None
    return _CTX.mesh.get_group(POD)


def pod_block(t: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
    """``t`` cut, on each dimension whose spec entry names "pod", to this
    rank's pod's contiguous block (``t`` as it is without one)."""
    n = pod_size()
    for d, entry in enumerate(spec):
        entry_t = (entry,) if isinstance(entry, str) else tuple(entry or ())
        if n > 1 and POD in entry_t:
            rows = t.shape[d] // n
            t = t.narrow(d, _CTX.mesh.get_local_rank(POD) * rows, rows)
    return t


def local_shape(shape: Sequence[int], spec: PartitionSpec) -> tuple:
    """A rank's shard shape of a tensor of ``shape`` under ``spec`` on the
    active mesh (every axis, "pod" too)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in (entry,) if isinstance(entry, str) else tuple(entry or ()):
            out[d] //= _CTX.sizes[a]
    return tuple(out)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def lc(x: torch.Tensor, axes: Sequence[Optional[str]]) -> torch.Tensor:
    """Logical sharding constraint: a ``DTensor`` redistributed to the
    placements of ``axes``; the identity outside a context and on a
    plain tensor (module docstring)."""
    if not active():
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"{len(axes)} logical axes {tuple(axes)} for a "
                         f"tensor of shape {tuple(x.shape)}")
    if not is_dtensor(x):
        return x
    # a DTensor's shape is its pod's block: the rules without "pod"
    placements = placements_for(
        _safe(x.shape, axes, _CTX.drules, _CTX.dsizes), _CTX.dsizes)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def einsum(equation: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; on ``DTensor`` operands, the product of the local
    shards, placed as the output's dimensions say.

    DTensor's own einsum flattens the batch dimensions into one, and in
    torch 2.11 it refuses to when a dimension after the first of them is
    sharded (a batch over "data" beside heads over "model").  Each mesh
    axis shards the letter the first operand shards on it (or the next
    operand's); an operand with that letter is redistributed to shard it
    too (a local slice where it was replicated), one without it is
    replicated there.  The output is sharded where the letter is kept and
    a ``Partial`` sum where the equation sums over it (its gradient
    replicated).  A ``Partial`` operand is reduced first."""
    if not any(is_dtensor(o) for o in operands):
        return torch.einsum(equation, *operands)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out = equation.replace(" ", "").split("->")
    specs = ins.split(",")
    mesh = next(o for o in operands if is_dtensor(o)).device_mesh
    letters: list = [None] * mesh.ndim
    for op, spec in zip(operands, specs):
        if not is_dtensor(op):
            continue
        for i, p in enumerate(op.placements):
            if letters[i] is None and p.is_shard():
                letters[i] = spec[p.dim]
    local = []
    for op, spec in zip(operands, specs):
        want = tuple(Shard(spec.index(x)) if x is not None and x in spec
                     else Replicate() for x in letters)
        # an operand without a sharded letter meets only that shard of the
        # others: its gradient is a partial sum over the mesh axis
        grads = tuple(Partial() if x is not None and x not in spec else w
                      for x, w in zip(letters, want))
        if not is_dtensor(op):
            op = DTensor.from_local(op, mesh, (Replicate(),) * mesh.ndim,
                                    run_check=False)
        if tuple(op.placements) != want:
            op = op.redistribute(mesh, want)
        local.append(_ToLocal.apply(op, grads))
    res = torch.einsum(equation, *local)
    placements = tuple(Replicate() if x is None else Shard(out.index(x))
                       if x in out else Partial() for x in letters)
    return _FromLocal.apply(res, mesh, placements)


class _ToLocal(torch.autograd.Function):
    """``x.to_local()`` whose gradient is placed as ``grad_placements``
    say (a ``Partial`` where the local product summed over a shard)."""

    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.mesh, ctx.placements = x.device_mesh, grad_placements
        local = x.to_local()
        return local.view(local.shape)

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(grad, ctx.mesh, ctx.placements,
                                  run_check=False), None


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose gradient is replicated where the
    output is a ``Partial`` sum (torch 2.11's from_local would return it
    redistributed to ``Partial``, divided by the axis size)."""

    @staticmethod
    def forward(ctx, local, mesh, placements):
        from torch.distributed.tensor import DTensor, Replicate
        ctx.mesh = mesh
        ctx.grads = tuple(Replicate() if p.is_partial() else p
                          for p in placements)
        return DTensor.from_local(local, mesh, placements, run_check=False)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.grads:
            grad = grad.redistribute(ctx.mesh, ctx.grads)
        return grad.to_local(), None, None


def split_last(x: torch.Tensor, sizes: tuple) -> torch.Tensor:
    """``x`` with its last dimension split into ``sizes``; a ``DTensor``
    whose last dimension is split over more shards than ``sizes[0]``
    divides is first replicated on it (torch 2.11's DTensor refuses that
    split; a head count that the "model" axis does not divide)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate
        mesh, last = x.device_mesh, x.ndim - 1
        on = [i for i, p in enumerate(x.placements) if p.is_shard(last)]
        if sizes[0] % math.prod(mesh.size(i) for i in on):
            x = x.redistribute(mesh, tuple(
                Replicate() if i in on else p
                for i, p in enumerate(x.placements)))
    return x.reshape(*x.shape[:-1], *sizes)


def pad(x: torch.Tensor, widths: tuple) -> torch.Tensor:
    """``F.pad(x, widths)`` (constant zeros); a ``DTensor`` whose padded
    dimensions are not sharded is padded shard by shard, as DTensor's own
    pad fails in torch 2.11."""
    import torch.nn.functional as F
    if not is_dtensor(x):
        return F.pad(x, widths)
    from torch.distributed.tensor import DTensor
    dims = [x.ndim - 1 - i for i in range(len(widths) // 2)
            if widths[2 * i] or widths[2 * i + 1]]
    if any(p.is_shard() and p.dim in dims for p in x.placements) \
            or any(p.is_partial() for p in x.placements):
        return F.pad(x, widths)
    return DTensor.from_local(F.pad(x.to_local(), widths), x.device_mesh,
                              x.placements, run_check=False)


def mesh_axis_size(name: str) -> int:
    if not active():
        return 1
    return _CTX.sizes.get(name, 1)
