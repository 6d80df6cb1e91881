"""Batched client execution: one vmapped local round per width bucket.

The synchronous loop trains each simulated device's local SGD in turn,
one minibatch at a time.  Devices in the same alpha bucket train the
*same sub-model shape* (EMS slices to the same widths), so each local
step of theirs is one ``torch.func.vmap`` call over stacked minibatches
(``AnycostClient._local_steps_batched``).  Inside that call a CNN runs
every lane's forward and backward at once with the lane axis written
out (``models/cnn_lanes``: the convolutions batched GEMMs on a card);
any other family's steps are vmap's per-op batching of ``grad``:

* ``train_shared``  — every client starts from the same (sorted, shrunk)
  global params (``in_dims=None``), one shrink per bucket instead of one
  per client, which it hands back in each job's ``sub_params`` for the
  update's decode.  The round-based policies use it.
* ``train_stacked`` — clients start from *different* model versions (a
  fedbuff buffer spans server versions): their params are stacked along
  the vmap axis (``in_dims=0``).

Groups are keyed by ``(alpha, n_steps, batch signature)`` and taken in
first-seen order; results come back in job order; a group of one runs
the plain per-client step.  A CNN's group larger than the card's free
memory holds (``cnn_lanes.lanes_that_fit``) trains in runs of as many
lanes as it does, each run a group of its own.

Unlike the reference, a group is not padded to a power of two of at least
8 lanes.  The reference pads only to bound XLA's compile cache (one
executable per group size); eager PyTorch compiles nothing per size, and
a padded lane is an independent copy of the group's first job whose
result is thrown away, so dropping the padding changes no result.
Stacking and unstacking stay on the run's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import shrinking
from repro_torch.core.anycost import AnycostClient
from repro_torch.models import cnn_lanes
from repro_torch.telemetry import wallclock
from repro_torch.utils.pytree import tree_leaves, tree_map

PyTree = Any


@dataclasses.dataclass
class TrainJob:
    """One client's local round, ready to train."""
    client_id: int
    alpha: float                      # bucketed width
    batches: dict                     # (steps, B, ...) stacked minibatches
    # the shrunk params it trains from: the caller's for train_stacked,
    # set by train_shared
    sub_params: Optional[PyTree] = None


def _tree_stack(trees: list) -> PyTree:
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def _batch_signature(batches: dict) -> tuple:
    return tuple((tuple(x.shape), str(x.dtype))
                 for x in tree_leaves(batches))


class ClientPool:
    """Groups same-shape clients and trains each group in one vmapped call."""

    def __init__(self, client: AnycostClient):
        self.client = client

    def _groups(self, jobs: list[TrainJob]) -> dict:
        groups: dict[tuple, list[int]] = {}
        for j, job in enumerate(jobs):
            n_steps = int(job.batches["images"].shape[0])
            key = (job.alpha, n_steps, _batch_signature(job.batches))
            groups.setdefault(key, []).append(j)
        return groups

    def _runs(self, idxs: list[int], jobs: list[TrainJob],
              params: PyTree) -> list[list[int]]:
        """A group's lanes in runs that the card holds at once."""
        if self.client.model.cfg.family != "cnn" or len(idxs) == 1:
            return [idxs]
        n = cnn_lanes.lanes_that_fit(params, jobs[idxs[0]].batches["images"])
        return [idxs[i:i + n] for i in range(0, len(idxs), n)]

    def _run_group(self, idxs: list[int], jobs: list[TrainJob],
                   params: PyTree, shared: bool) -> list[PyTree]:
        first = jobs[idxs[0]]
        with wallclock.span("train.group", {
                "alpha": first.alpha, "lanes": len(idxs),
                "steps": int(first.batches["images"].shape[0])}):
            if len(idxs) == 1:
                p = params if shared else first.sub_params
                return [self.client._local_steps(p, first.batches)]
            with wallclock.span("train.stack"):
                stacked_b = _tree_stack([jobs[j].batches for j in idxs])
                if not shared:
                    params = _tree_stack([jobs[j].sub_params for j in idxs])
            out = self.client._local_steps_batched(params, stacked_b,
                                                   shared=shared)
            with wallclock.span("train.unstack"):
                return [tree_map(lambda x, i=i: x[i], out)
                        for i in range(len(idxs))]

    def train_shared(self, sorted_global: PyTree,
                     jobs: list[TrainJob]) -> list[PyTree]:
        """Train every job from one global model, shrunk once per width
        bucket; the trained params per job, in job order.  Sets each
        job's ``sub_params`` to the shrunk params it trained from."""
        out: list = [None] * len(jobs)
        subs: dict = {}
        with wallclock.span("train"):
            for (alpha, _, _), idxs in self._groups(jobs).items():
                if alpha not in subs:
                    with wallclock.span("train.shrink"):
                        subs[alpha] = shrinking.shrink(sorted_global, alpha,
                                                       self.client.spec)
                sub = subs[alpha]
                for j in idxs:
                    jobs[j].sub_params = sub
                for run in self._runs(idxs, jobs, sub):
                    for j, trained in zip(run, self._run_group(
                            run, jobs, sub, shared=True)):
                        out[j] = trained
        return out

    def train_stacked(self, jobs: list[TrainJob]) -> list[PyTree]:
        """Train jobs that carry their own (per-version) sub params."""
        out: list = [None] * len(jobs)
        with wallclock.span("train"):
            for idxs in self._groups(jobs).values():
                for run in self._runs(idxs, jobs, jobs[idxs[0]].sub_params):
                    for j, trained in zip(run, self._run_group(
                            run, jobs, None, shared=False)):
                        out[j] = trained
        return out
