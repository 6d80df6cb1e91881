"""EMS — Elastic Model Shrinking (paper §III-B).

A :class:`ShrinkSpec` describes the *width groups* of a model: sets of
parameter dims that share one hidden width and must be sliced consistently.
Per group:

* ``sort_by`` names the producing weight whose per-channel L2 norm ranks
  importance (server-side channel sorting, §III-B.1). The permutation is
  applied to every entry of the group — output side of the producing layer
  and input side of the consuming layer(s) — preserving the function.
* ``shrink`` keeps the first ``ceil(size * sqrt(alpha))`` channels
  (layer-wise uniform shrinking, §III-B.2), rounded to ``round_to``.

The server keeps the global model permanently in sorted coordinates:
sort -> distribute slices -> aggregate sub-updates (zero-padded back to
full width) -> apply.

Entries address a dim that may be *structured*: ``(path, axis, outer,
block)`` views the axis as (outer, size, block) — e.g. flattened conv
feature maps (outer=H*W spatial positions, block=1) feeding a dense layer.
The sort is a stable argsort, as ``jnp.argsort`` is, so ties keep the
reference's order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Entry:
    path: str          # dotted path into the params dict
    axis: int
    outer: int = 1     # axis viewed as (outer, size, block)
    block: int = 1


@dataclasses.dataclass(frozen=True)
class WidthGroup:
    name: str
    size: int                    # number of channels (groups of lanes)
    entries: tuple                # tuple[Entry, ...]
    sort_by: Entry               # producing weight used for importance
    round_to: int = 1


@dataclasses.dataclass(frozen=True)
class ShrinkSpec:
    groups: tuple                 # tuple[WidthGroup, ...]

    def widths(self, alpha: float) -> dict[str, int]:
        m = math.sqrt(alpha)
        out = {}
        for g in self.groups:
            n = max(int(math.ceil(g.size * m)), g.round_to)
            n = min(int(math.ceil(n / g.round_to)) * g.round_to, g.size)
            out[g.name] = n
        return out


# ------------------------------------------------------------ dict plumbing

def _get(tree: PyTree, path: str):
    node = tree
    for part in path.split("."):
        node = node[part]
    return node


def _set(tree: PyTree, path: str, value) -> None:
    parts = path.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value


def _view(x: torch.Tensor, e: Entry, size: int) -> torch.Tensor:
    """Reshape entry axis (outer*size*block) -> (outer, size, block)."""
    shape = tuple(x.shape)
    if shape[e.axis] != e.outer * size * e.block:
        raise ValueError(f"{e} does not address {size} channels of "
                         f"shape {shape}")
    new = shape[:e.axis] + (e.outer, size, e.block) + shape[e.axis + 1:]
    return x.reshape(new)


def _unview(x: torch.Tensor, e: Entry) -> torch.Tensor:
    shape = tuple(x.shape)
    new = shape[:e.axis] + (shape[e.axis] * shape[e.axis + 1]
                            * shape[e.axis + 2],) + shape[e.axis + 3:]
    return x.reshape(new)


def _take(x: torch.Tensor, e: Entry, size: int,
          idx: torch.Tensor) -> torch.Tensor:
    v = _view(x, e, size)
    return _unview(torch.index_select(v, e.axis + 1, idx), e)


def _deepcopy_dicts(tree: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: _deepcopy_dicts(v) for k, v in tree.items()}
    return tree


def _all_paths(tree: PyTree, prefix: str = "") -> list[str]:
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out.extend(_all_paths(v, f"{prefix}{k}."))
        return out
    return [prefix[:-1]]


def _entries_by_path(spec: ShrinkSpec) -> dict[str, list]:
    todo: dict[str, list] = {}
    for g in spec.groups:
        for e in g.entries:
            todo.setdefault(e.path, []).append((e, g))
    return todo


# ------------------------------------------------------------------ sorting

def channel_importance(params: PyTree, g: WidthGroup) -> torch.Tensor:
    """Per-channel L2 norm of the producing weight (descending = important)."""
    w = _get(params, g.sort_by.path)
    v = _view(w, g.sort_by, g.size)
    axes = tuple(i for i in range(v.dim()) if i != g.sort_by.axis + 1)
    return torch.sqrt(v.float().square().sum(dim=axes))


def sort_channels(params: PyTree, spec: ShrinkSpec, *,
                  return_perms: bool = False):
    """Server-side channel sorting (§III-B.1). Function-preserving.

    With ``return_perms`` the per-group permutations are handed back too."""
    out = _deepcopy_dicts(params)
    perms = []
    for g in spec.groups:
        imp = channel_importance(out, g)
        perm = torch.argsort(-imp, stable=True)
        perms.append(perm)
        for e in g.entries:
            _set(out, e.path, _take(_get(out, e.path), e, g.size, perm))
    if return_perms:
        return out, perms
    return out


# ----------------------------------------------------------------- shrinking

def shrink(params: PyTree, alpha: float, spec: ShrinkSpec) -> PyTree:
    """Slice the (already sorted) params to the alpha sub-model."""
    widths = spec.widths(alpha)
    out = _deepcopy_dicts(params)
    for g in spec.groups:
        n = widths[g.name]
        for e in g.entries:
            v = _view(_get(out, e.path), e, g.size)
            _set(out, e.path, _unview(v.narrow(e.axis + 1, 0, n), e))
    return out


def expand_update(sub_update: PyTree, full_template: PyTree, alpha: float,
                  spec: ShrinkSpec) -> tuple[PyTree, PyTree]:
    """Zero-pad a sub-model update back to full width (sorted coords).

    Returns (full_update, elementwise {0,1} float32 mask of covered
    coordinates).  ``full_template`` is unused, as in the reference.
    """
    widths = spec.widths(alpha)
    upd = _deepcopy_dicts(sub_update)
    mask = _deepcopy_dicts(sub_update)
    for path in _all_paths(upd):
        _set(mask, path, torch.ones_like(_get(upd, path),
                                         dtype=torch.float32))
    todo = _entries_by_path(spec)

    def pad_leaf(tree, path):
        x = _get(tree, path)
        for e, g in todo.get(path, []):
            n = widths[g.name]
            v = _view(x, e, n)
            shape = list(v.shape)
            shape[e.axis + 1] = g.size
            padded = v.new_zeros(shape)
            padded.narrow(e.axis + 1, 0, n).copy_(v)
            x = _unview(padded, e)
        _set(tree, path, x)

    for path in _all_paths(upd):
        pad_leaf(upd, path)
        pad_leaf(mask, path)
    return upd, mask


def width_mask_template(full_template: PyTree, alpha: float,
                        spec: ShrinkSpec) -> PyTree:
    """The {0,1} float32 coverage mask of the alpha sub-model from the
    full template alone: the ``width_mask`` :func:`expand_update` returns,
    ones everywhere but outside the kept channel slice of each group
    entry."""
    widths = spec.widths(alpha)
    mask = _deepcopy_dicts(full_template)
    for path in _all_paths(mask):
        _set(mask, path, torch.ones_like(_get(mask, path),
                                         dtype=torch.float32))
    for path, pairs in _entries_by_path(spec).items():
        x = _get(mask, path)
        for e, g in pairs:
            v = _view(x, e, g.size)
            keep = (torch.arange(g.size, device=v.device)
                    < widths[g.name]).to(torch.float32)
            shape = [1] * v.dim()
            shape[e.axis + 1] = g.size
            x = _unview(v * keep.reshape(shape), e)
        _set(mask, path, x)
    return mask


def effective_alpha(spec: ShrinkSpec, alpha: float, full_template: PyTree
                    ) -> float:
    """Realized FLOP fraction ~ parameter fraction of the alpha
    sub-model, from the group widths leaf by leaf."""
    full = sum(_get(full_template, p).numel()
               for p in _all_paths(full_template))
    widths = spec.widths(alpha)
    todo = _entries_by_path(spec)
    sub_total = 0
    for p in _all_paths(full_template):
        factor = 1.0
        for e, g in todo.get(p, []):
            factor *= widths[g.name] / g.size
        sub_total += _get(full_template, p).numel() * factor
    return sub_total / full


# ------------------------------------------------------- spec constructors

def cnn_shrink_spec(cfg) -> ShrinkSpec:
    """Width groups for the paper's CNN / VGG-9 (§V-A models)."""
    c = cfg.d_model
    if cfg.name.startswith("fmnist"):
        g1 = WidthGroup(
            "conv1", c,
            entries=(Entry("conv1.w", 3), Entry("conv1.b", 0),
                     Entry("conv2.w", 2)),
            sort_by=Entry("conv1.w", 3))
        g2 = WidthGroup(
            "conv2", 2 * c,
            entries=(Entry("conv2.w", 3), Entry("conv2.b", 0),
                     Entry("dense1.w", 0, outer=49, block=1)),
            sort_by=Entry("conv2.w", 3))
        g3 = WidthGroup(
            "dense1", cfg.d_ff,
            entries=(Entry("dense1.w", 1), Entry("dense1.b", 0),
                     Entry("dense2.w", 0)),
            sort_by=Entry("dense1.w", 1))
        return ShrinkSpec((g1, g2, g3))
    # VGG-9
    groups = []
    chans = [c, c, 2 * c, 2 * c, 4 * c, 4 * c]
    for i in range(6):
        name = f"conv{i + 1}"
        nxt = f"conv{i + 2}"
        entries = [Entry(f"{name}.w", 3), Entry(f"{name}.b", 0)]
        if i < 5:
            entries.append(Entry(f"{nxt}.w", 2))
        else:
            entries.append(Entry("dense1.w", 0, outer=16, block=1))
        groups.append(WidthGroup(name, chans[i], tuple(entries),
                                 sort_by=Entry(f"{name}.w", 3)))
    groups.append(WidthGroup(
        "dense1", cfg.d_ff,
        entries=(Entry("dense1.w", 1), Entry("dense1.b", 0),
                 Entry("dense2.w", 0)),
        sort_by=Entry("dense1.w", 1)))
    groups.append(WidthGroup(
        "dense2", cfg.d_ff,
        entries=(Entry("dense2.w", 1), Entry("dense2.b", 0),
                 Entry("dense3.w", 0)),
        sort_by=Entry("dense2.w", 1)))
    return ShrinkSpec(tuple(groups))


def transformer_shrink_spec(cfg, params_template: PyTree,
                            round_to: int = 1) -> ShrinkSpec:
    """Width groups for the decoder-LM families.

    EMS shrinks the hidden widths whose slicing preserves the function:
    the MLP d_ff, the SSM d_inner, and the q-head count (whole heads,
    ``wo``'s input tracked).  d_model, the residual stream, is kept.
    Entries address the stacked-layer arrays (the leading ``layers`` axis
    shifts each axis by one).
    """
    groups = []
    blocks = params_template.get("blocks", {})
    if "mlp" in blocks:
        gate = "w_gate" if "w_gate" in blocks["mlp"] else "w_up"
        groups.append(WidthGroup(
            "mlp", cfg.d_ff,
            entries=tuple([Entry(f"blocks.mlp.{k}", 2)
                           for k in ("w_gate", "w_up") if k in blocks["mlp"]]
                          + [Entry("blocks.mlp.w_down", 1)]),
            sort_by=Entry(f"blocks.mlp.{gate}", 2), round_to=round_to))
    if "attn" in blocks and cfg.n_kv_heads:
        # GQA-safe: heads viewed as (kv group, group size, head_dim) and the
        # group size shrunk, so every kv group keeps as many q heads
        hd = cfg.resolved_head_dim
        kv = cfg.n_kv_heads
        gsz = cfg.n_heads // kv
        if gsz > 1:
            entries = [Entry("blocks.attn.wq.w", 2, outer=kv, block=hd),
                       Entry("blocks.attn.wo.w", 1, outer=kv, block=hd)]
            if "b" in blocks["attn"]["wq"]:
                entries.append(Entry("blocks.attn.wq.b", 1, outer=kv,
                                     block=hd))
            groups.append(WidthGroup(
                "heads", gsz, tuple(entries),
                sort_by=Entry("blocks.attn.wq.w", 2, outer=kv, block=hd)))
    if "in_x" in blocks:  # mamba
        s = cfg.ssm
        groups.append(WidthGroup(
            "d_inner", s.d_inner,
            entries=(Entry("blocks.in_x.w", 2), Entry("blocks.in_z.w", 2),
                     Entry("blocks.conv_w", 2), Entry("blocks.conv_b", 1),
                     Entry("blocks.w_dt.w", 1), Entry("blocks.w_B.w", 1),
                     Entry("blocks.w_C.w", 1), Entry("blocks.dt_proj.w", 2),
                     Entry("blocks.dt_bias", 1), Entry("blocks.A_log", 1),
                     Entry("blocks.D", 1), Entry("blocks.out.w", 1)),
            sort_by=Entry("blocks.in_x.w", 2), round_to=round_to))
    return ShrinkSpec(tuple(groups))


def shrunk_config(cfg, alpha: float, spec: ShrinkSpec):
    """ArchConfig of the alpha sub-model (the LM code reads its dims from
    the config; the CNN's read them from the params)."""
    widths = spec.widths(alpha)
    if "conv1" in widths:
        return cfg
    kw = {}
    if "mlp" in widths:
        kw["d_ff"] = widths["mlp"]
    if "heads" in widths and cfg.n_kv_heads:
        kw["n_heads"] = cfg.n_kv_heads * widths["heads"]
    if "d_inner" in widths and cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_inner=widths["d_inner"])
    return dataclasses.replace(cfg, **kw) if kw else cfg
