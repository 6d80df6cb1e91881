"""AnycostFL single-round logic (client + server), paper §III-A.

The three-step round:
  1) elastic local training  — shrink(w_t, alpha_i), tau local epochs of SGD
  2) flexible gradient upload — cmprs(u_i, beta_i) (FGC)
  3) parameter aggregation    — aioagg({u~_i}) with Theorem-1 weights
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import aggregation, compression, shrinking
from repro_torch.core.schedule import Strategy
from repro_torch.models import cnn_lanes
from repro_torch.models.registry import Model, loss_fn
from repro_torch.telemetry import wallclock
from repro_torch.utils.pytree import (flat_vector, split_vector,
                                      tree_leaves, tree_map, tree_size,
                                      tree_sub, tree_unflatten)

PyTree = Any

# discrete alpha buckets: the paper's alpha is continuous; widths on real
# hardware are bucketed to efficient sizes
DEFAULT_ALPHA_BUCKETS = (0.25, 0.4, 0.55, 0.7, 0.85, 1.0)


def bucket_alpha(alpha: float, buckets=DEFAULT_ALPHA_BUCKETS) -> float:
    """Largest bucket <= alpha (never exceed the computed budget)."""
    below = [b for b in buckets if b <= alpha + 1e-9]
    return below[-1] if below else buckets[0]


@dataclasses.dataclass
class ClientUpdate:
    """What the device uploads (server view, decoded)."""
    values: PyTree             # full-coordinate update, zeros where absent
    mask: PyTree               # {0,1} transmitted-coordinate mask
    alpha: float
    beta_target: float
    beta_realized: float       # modelled wire bits / (32 * |update|)
    bits: float
    n_samples: int
    flops: float               # actual local training FLOPs spent


class AnycostClient:
    """Device-side logic."""

    def __init__(self, model: Model, spec: shrinking.ShrinkSpec, *,
                 lr: float, batch_size: int,
                 alpha_buckets=DEFAULT_ALPHA_BUCKETS):
        self.model = model
        self.spec = spec
        self.lr = lr
        self.batch_size = batch_size
        self.alpha_buckets = alpha_buckets

    def _local_steps(self, params: PyTree, batches: dict) -> PyTree:
        """Plain SGD, ``p <- p - lr * grad``, over the stacked minibatches
        ``batches[k]: (steps, B, ...)``.  The CNN reads its widths from the
        parameter shapes, so one model serves every sub-model."""
        lr = self.lr
        p = tree_map(lambda t: t.detach().clone(), params)
        for s in range(batches["images"].shape[0]):
            with wallclock.span("train.step"):
                batch = {k: v[s] for k, v in batches.items()}
                leaves = [t.requires_grad_() for t in tree_leaves(p)]
                loss = loss_fn(self.model, tree_unflatten(p, leaves), batch)
                grads = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    p = tree_unflatten(p, [a - lr * g.to(a.dtype)
                                           for a, g in zip(leaves, grads)])
        return p

    def _local_steps_batched(self, params: PyTree, batches: dict, *,
                             shared: bool) -> PyTree:
        """:meth:`_local_steps` on every lane of a leading axis at once:
        ``batches[k]: (lanes, steps, B, ...)``; ``params`` either one tree
        that every lane starts from (``shared=True``, ``in_dims=None``)
        or stacked ``(lanes, ...)`` (``in_dims=0``).  Each step is one
        ``torch.func.vmap`` of the loss's gradient and the same update
        ``p - lr * grad``; the returned leaves are stacked per lane.  For
        a CNN the vmapped function is
        :func:`~repro_torch.models.cnn_lanes.lane_grad`'s, which runs every
        lane's forward and backward at once with the lane axis written out
        and differentiates only the loss by ``grad`` (counter
        ``train.lane_steps``, lanes a step); for any other family it is
        vmap's per-op batching of ``grad`` of the whole loss
        (``train.vmap_grad_steps``).  The convolutions sum in another
        order than one client's alone, so a lane agrees with
        :meth:`_local_steps` up to float32 rounding."""
        model, lr = self.model, self.lr
        lanes = batches["images"].shape[0]
        if model.cfg.family == "cnn":
            # the loss of given logits, as loss_fn defines it
            logits = model._replace(forward=lambda z, batch, **kw: z)
            grad = cnn_lanes.lane_grad(
                lambda z, batch: loss_fn(logits, z, batch))
            counter = "train.lane_steps"
        else:
            grad = torch.func.grad(lambda q, batch: loss_fn(model, q, batch))
            counter = "train.vmap_grad_steps"
        p, in_dims = params, None if shared else 0
        for s in range(batches["images"].shape[1]):
            with wallclock.span("train.step"):
                batch = {k: v[:, s] for k, v in batches.items()}
                g = torch.func.vmap(grad, in_dims=(in_dims, 0))(p, batch)
                p = tree_map(lambda a, b: a - lr * b.to(a.dtype), p, g)
                wallclock.count(counter, lanes)
            in_dims = 0
        return p

    def local_round(self, sorted_global: PyTree, strategy: Strategy,
                    batches: dict, gen: torch.Generator, *,
                    planner: Optional[compression.BetaPlanner] = None,
                    w_per_sample: float = 0.0) -> ClientUpdate:
        """One full device round: shrink -> train -> compress -> (upload).
        The quantization's uniforms, one an element of the full-width
        update, are drawn from ``gen``, a generator on the parameters'
        device (the reference's ``key``)."""
        alpha = bucket_alpha(strategy.alpha, self.alpha_buckets)
        sub = shrinking.shrink(sorted_global, alpha, self.spec)
        n_steps = batches["images"].shape[0]
        trained = self._local_steps(sub, batches)
        rand = torch.rand(tree_size(sorted_global), generator=gen,
                          device=tree_leaves(sorted_global)[0].device)
        return self.finish_round(sorted_global, alpha, trained, strategy,
                                 n_steps, rand, planner=planner,
                                 w_per_sample=w_per_sample, sub=sub)

    def finish_plan(self, beta: float,
                    planner: Optional[compression.BetaPlanner] = None
                    ) -> tuple[float, float]:
        """(rho, n_levels) for a target rate — planner map or Appendix A."""
        if planner is not None:
            rho, levels = planner.plan(beta)
            return rho, float(levels)
        return (compression.analytic_rho(beta),
                compression.analytic_levels(beta))

    def finish_round(self, sorted_global: PyTree, alpha: float,
                     trained: PyTree, strategy: Strategy, n_steps: int,
                     rand: torch.Tensor, *,
                     planner: Optional[compression.BetaPlanner] = None,
                     w_per_sample: float = 0.0,
                     sub: Optional[PyTree] = None) -> ClientUpdate:
        """Decode an already-trained sub-model into the uploaded update.

        ``alpha`` must be the bucketed width actually trained; ``rand``
        holds one uniform per element of the full-width update."""
        if sub is None:
            sub = shrinking.shrink(sorted_global, alpha, self.spec)
        with wallclock.span("materialize.expand"):
            update_sub = tree_sub(sub, trained)      # u = w_before - w_after
            full_update, width_mask = shrinking.expand_update(
                update_sub, sorted_global, alpha, self.spec)
        with wallclock.span("materialize.compress"):
            beta = float(strategy.beta)
            rho, levels = self.finish_plan(beta, planner)
            comp = compression.compress_update(full_update, beta, rand,
                                               rho=rho, n_levels=levels)
            # the transmitted mask = width mask AND sparsity mask; both
            # trees are views of one flat buffer each, which the streaming
            # aggregation reads without a copy
            mask_vec = flat_vector(width_mask) * flat_vector(comp.mask)
            mask = split_vector(width_mask, mask_vec)
            values = split_vector(width_mask,
                                  flat_vector(comp.values) * mask_vec)
        with wallclock.span("materialize.costs"):
            n = tree_size(full_update)
            n_samples = n_steps * self.batch_size
            bits = float(comp.bits)
            return ClientUpdate(
                values=values, mask=mask, alpha=alpha, beta_target=beta,
                beta_realized=bits / (32.0 * n), bits=bits,
                n_samples=n_samples, flops=alpha * w_per_sample * n_samples)


class AnycostServer:
    """Server-side: channel sorting, AIO aggregation, model update."""

    def __init__(self, model: Model, spec: shrinking.ShrinkSpec,
                 *, server_lr: float = 1.0):
        self.model = model
        self.spec = spec
        self.server_lr = server_lr

    def sort(self, params: PyTree) -> PyTree:
        return shrinking.sort_channels(params, self.spec)

    def apply_update(self, params: PyTree, agg: PyTree) -> PyTree:
        """One server step: w <- w - server_lr * aggregated update."""
        return tree_map(
            lambda p, g: (p.float() - self.server_lr * g.float()).to(p.dtype),
            params, agg)

    def aggregate(self, params: PyTree, updates: list[ClientUpdate],
                  *, weights: Optional[torch.Tensor] = None) -> PyTree:
        if weights is None:
            weights = aggregation.optimal_coefficients(
                [u.alpha for u in updates],
                [max(u.beta_target, 1e-6) for u in updates])
        with wallclock.span("aggregate.aio"):
            agg = aggregation.aio_aggregate([u.values for u in updates],
                                            [u.mask for u in updates],
                                            weights)
        with wallclock.span("aggregate.apply"):
            return self.apply_update(params, agg)
