"""Helpers over nested dicts of tensors.

Leaves are always walked in sorted-key order, the order
``jax.tree_util`` gives the reference's dict pytrees, so flat vectors,
kernel ids and masks line up with the reference element for element.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Iterable

import torch

PyTree = Any


def tree_leaves(tree: PyTree) -> list:
    """Leaves in sorted-key order."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k]))
        return out
    return [tree]


def tree_unflatten(template: PyTree, leaves) -> PyTree:
    """Rebuild ``template``'s dict structure around ``leaves`` (sorted-key
    order, as :func:`tree_leaves` returns them)."""
    return _build(template, iter(leaves))


def _build(node: PyTree, it) -> PyTree:
    # a module-level function: a nested one that calls itself would hold
    # ``it``, and through it every leaf, in a reference cycle until the
    # garbage collector runs (a train step's gradients outlived the step)
    if isinstance(node, dict):
        return {k: _build(node[k], it) for k in sorted(node)}
    return next(it)


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def tree_size(tree: PyTree) -> int:
    """Total number of scalar elements."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree: PyTree) -> int:
    """Total bytes of the tensor leaves, by element size (bf16 is 2)."""
    return sum(math.prod(x.shape) * x.element_size()
               for x in tree_leaves(tree) if hasattr(x, "shape"))


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.add, a, b)


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_scale(tree: PyTree, s) -> PyTree:
    """Each leaf times ``s``.  A Python number is first rounded to a
    floating leaf's dtype, as JAX rounds a weakly typed scalar: a bf16
    leaf times 0.3 is the bf16 product of two bf16 values."""
    def scale(x):
        if isinstance(s, (int, float)) and x.is_floating_point():
            return x * torch.tensor(s, dtype=x.dtype).item()
        return x * s
    return tree_map(scale, tree)


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    # a half-precision product accumulates in float32 and rounds once
    # to the promoted dtype, as XLA's bf16 dot does
    dtype = torch.promote_types(x.dtype, y.dtype)
    acc = torch.float32 if dtype.itemsize < 4 else dtype
    return torch.vdot(x.reshape(-1).to(acc),
                      y.reshape(-1).to(acc)).to(dtype)


def tree_dot(a: PyTree, b: PyTree) -> torch.Tensor:
    """Sum of the leaves' ``vdot``s, a left fold in leaf order."""
    parts = [_vdot(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b))]
    return functools.reduce(torch.add, parts)


def tree_l2(tree: PyTree) -> torch.Tensor:
    """Global L2 norm over all leaves (float32)."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


def tree_any_nan(tree: PyTree) -> torch.Tensor:
    """0-d bool tensor on the leaves' device: any non-finite value (NaN
    or inf), checked in float32; no host read."""
    flags = [torch.any(~torch.isfinite(x.float())) for x in tree_leaves(tree)]
    return functools.reduce(torch.logical_or, flags)


def tree_cast(tree: PyTree, dtype: torch.dtype) -> PyTree:
    return tree_map(lambda x: x.to(dtype), tree)


def flatten_to_vector(tree: PyTree) -> tuple[torch.Tensor, Callable]:
    """Flatten into one float32 vector; returns it and an unflatten
    closure that restores shapes and dtypes."""
    leaves = tree_leaves(tree)
    shapes = [tuple(x.shape) for x in leaves]
    dtypes = [x.dtype for x in leaves]
    vec = torch.cat([x.float().reshape(-1) for x in leaves])

    def unflatten(v: torch.Tensor) -> PyTree:
        out = []
        off = 0
        for shape, dtype in zip(shapes, dtypes):
            n = math.prod(shape)
            out.append(v[off:off + n].reshape(shape).to(dtype))
            off += n
        return tree_unflatten(tree, out)

    return vec, unflatten


def flat_vector(tree: PyTree) -> torch.Tensor:
    """The leaves (sorted-key order) as one flat float32 vector.

    A view, with no copy, when the leaves are contiguous float32 tensors
    that tile one buffer in that order (as :func:`split_vector` leaves
    them); a fresh ``torch.cat`` otherwise."""
    leaves = tree_leaves(tree)
    first = leaves[0]
    if all(x.dtype == torch.float32 and x.is_contiguous() for x in leaves):
        base = first.untyped_storage().data_ptr()
        end = first.storage_offset()
        for x in leaves:
            if x.untyped_storage().data_ptr() != base \
                    or x.storage_offset() != end:
                break
            end += x.numel()
        else:
            return first.as_strided((end - first.storage_offset(),), (1,))
    return torch.cat([x.float().reshape(-1) for x in leaves])


def split_vector(template: PyTree, vec: torch.Tensor) -> PyTree:
    """Views of a flat vector, one per leaf of ``template`` (sorted-key
    order), in its structure and leaf shapes."""
    out = []
    off = 0
    for x in tree_leaves(template):
        n = x.numel()
        out.append(vec[off:off + n].view(x.shape))
        off += n
    return tree_unflatten(template, out)


def named_leaves(tree: PyTree, prefix: str = "") -> Iterable[tuple[str, Any]]:
    """Yield ``(dotted_path, leaf)`` pairs of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], f"{prefix}{k}.")
    else:
        yield prefix.rstrip("."), tree


def map_named(fn: Callable[[str, Any], Any], tree: PyTree,
              prefix: str = "") -> PyTree:
    """Map ``fn(dotted_path, leaf)`` over a nested dict, keeping its
    insertion order."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, f"{prefix}{k}.") for k, v in tree.items()}
    return fn(prefix.rstrip("."), tree)
