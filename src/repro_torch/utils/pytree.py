"""Helpers over nested dicts of tensors.

Leaves are always walked in sorted-key order, the order
``jax.tree_util`` gives the reference's dict pytrees, so flat vectors,
kernel ids and masks line up with the reference element for element.
"""
from __future__ import annotations

import math
from typing import Any, Callable

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


def tree_sub(a: PyTree, b: PyTree) -> PyTree:
    return tree_map(torch.sub, a, b)


def tree_l2(tree: PyTree) -> torch.Tensor:
    """Global L2 norm over all leaves (float32)."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    return torch.sqrt(total)


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
