"""Optimizers as (init, update) pairs over nested dicts of tensors, the
reference's (``repro/train/optimizer.py``) operation by operation.

``update(params, grads, state)`` writes the new parameters and the new
state into the tensors it was given and returns them, ``(params,
state)``; the reference returns new trees.  At published widths the
functional form does not fit one card beside the moments (phi3-mini-3.8b:
7.6 GB of bf16 parameters, 30.6 GB of float32 moments, and as much again
for their copies), so the update goes leaf by leaf and keeps at most two
of a leaf's float32 temporaries alive.

The moments are float32 whatever the parameter dtype, and ``step`` is an
int32 tensor on the parameters' device, so a step reads nothing back to
the host.  ``DTensor`` parameters (the sharded train step,
``launch/steps.py``) get moments of their placements, and every update
runs on the local shards, operation for operation the same: on a
one-rank mesh it is the plain update bit for bit.  Every product and
sum is its own rounding, as in the reference: no ``alpha=`` or
``addcmul_`` form that could fuse a multiply into an add.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.utils.pytree import PyTree, tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


def _step0(params: PyTree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _zeros_f32(params: PyTree) -> PyTree:
    # a DTensor parameter's moment is a DTensor of its placements
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def _sqrt_(x: torch.Tensor) -> torch.Tensor:
    """``x``'s correctly rounded float32 square root, in place, as the
    reference's ``jnp.sqrt``.  The CPU build's float32 ``torch.sqrt`` is
    one ulp off for some inputs (``core/aggregation.sqrt_f32``), so the
    CPU takes it in float64, whose rounding to float32 is exact."""
    if x.is_cuda:
        return x.sqrt_()
    return x.copy_(torch.sqrt(x.double()))


def sgd(lr: float) -> Optimizer:
    def init(params):
        return {"step": _step0(params)}

    @torch.no_grad()
    def update(params, grads, state):
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            # lr in the parameter dtype, as the reference's weakly typed
            # ``lr * g`` rounds it (a bf16 leaf multiplies by bf16(lr))
            p.sub_(g.to(p.dtype) * torch.tensor(lr, dtype=p.dtype))
        state["step"].add_(1)
        return params, state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params)}

    @torch.no_grad()
    def update(params, grads, state):
        for p, g, m in zip(tree_leaves(params), tree_leaves(grads),
                           tree_leaves(state["m"])):
            m.mul_(beta).add_(g.to(torch.float32))
            p.sub_((m * lr).to(p.dtype))
        state["step"].add_(1)
        return params, state

    return Optimizer(init, update)


def adamw(lr: float, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, warmup: int = 0) -> Optimizer:
    def init(params):
        return {"step": _step0(params), "m": _zeros_f32(params),
                "v": _zeros_f32(params)}

    @torch.no_grad()
    def update(params, grads, state):
        step = state["step"].add_(1)
        sched = lr
        if warmup:
            sched = lr * torch.clamp(step / warmup, max=1.0)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, t)
        bc2 = 1 - torch.pow(b2, t)
        for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            g = g.to(torch.float32)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g.square().mul_(1 - b2))
            del g
            upd = m / bc1                       # mhat
            den = _sqrt_(v / bc2).add_(eps)
            upd.div_(den)                       # mhat / (sqrt(vhat) + eps)
            den.copy_(p).mul_(weight_decay)     # weight_decay * p (float32)
            upd.add_(den).mul_(sched)           # delta
            p.copy_(den.copy_(p).sub_(upd))     # p - delta, cast back
            del upd, den        # before the next leaf's temporaries
        return params, state

    return Optimizer(init, update)


def get_optimizer(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "momentum":
        return momentum(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(name)
