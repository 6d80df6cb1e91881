"""Step functions and input specs for the trainer and the server.

  train_step(params, opt_state, batch)   -> (params, opt_state, loss)
  prefill_step(params, batch)            -> logits        (prefill)
  serve_step(params, cache, batch)       -> (logits, cache)  (1-token decode)

The train step writes the parameters and the optimizer state in place
(``train/optimizer.py``) and returns them with the loss, a tensor on the
device.  ``grad_sync``:
  "auto"     the one-device step.
  "anycost"  one rank a pod: each rank takes its block of the batch, and
             the gradients are synced with the compressed collective
             (``core/distributed.py``) over the mesh's "pod" group.
The reference's sharding helpers (``param_shardings``,
``opt_state_shardings``, ``batch_shardings``, ``cache_shardings``,
``grads_spec``) and per-shape rules (``rules_for``,
``make_step_and_args``) are not ported: they need logical axes on the
port's models and sharded parameters (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.distributed import anycost_gradient_sync
from repro_torch.models.registry import Model, loss_fn
from repro_torch.train.optimizer import Optimizer
from repro_torch.utils.pytree import tree_leaves, tree_unflatten


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Stand-ins for a step's batch on the ``meta`` device (shapes and
    dtypes, no storage)."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device="meta")}
    if cfg.family == "vlm" and shape.kind != "decode":
        v = cfg.vlm
        specs["patch_embeds"] = torch.empty(
            (B, v.n_patches, v.patch_embed_dim), dtype=cfg.param_dtype,
            device="meta")
    if cfg.family == "encdec" and shape.kind != "decode":
        e = cfg.encdec
        specs["frames"] = torch.empty((B, e.n_frames, cfg.d_model),
                                      dtype=cfg.param_dtype, device="meta")
    return specs


def value_and_grad(model: Model, params, batch, **kw):
    """(loss, grads): the loss on ``batch`` and its gradient with respect
    to every parameter leaf, in the parameters' tree and dtypes (a leaf
    the loss does not reach gets zeros, as ``jax.value_and_grad`` gives
    it).  ``kw`` goes to the model's forward (``remat``,
    ``causal_skip``).  The loss is detached and stays on the device."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    loss = loss_fn(model, tree_unflatten(params, leaves), batch, **kw)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, opt: Optimizer, *, remat: str = "full",
                    causal_skip: bool = False, grad_sync: str = "auto",
                    keep_frac: float = 1.0 / 16.0, mesh=None):
    """The reference's train step: the loss and gradients under ``remat``
    (``"full"``, ``"dots"`` or ``"none"``), then ``opt.update`` in place.

    ``grad_sync="anycost"`` needs ``mesh``, a ``DeviceMesh`` with a "pod"
    dimension (``launch/mesh.make_pod_mesh``).  Every rank is given the
    global batch and takes its contiguous block of the leading axis by its
    pod rank (the reference's ``P("pod")`` in_spec); its gradients are
    synced in place with ``anycost_gradient_sync`` at ``keep_frac``, the
    loss is averaged over the pods, and every rank makes the same
    update."""
    def local_grads(params, batch):
        return value_and_grad(model, params, batch, remat=remat,
                              causal_skip=causal_skip)

    if grad_sync == "auto":
        def train_step(params, opt_state, batch):
            loss, grads = local_grads(params, batch)
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss

        return train_step

    if grad_sync == "anycost":
        if mesh is None:
            raise ValueError("anycost sync needs the mesh")
        dist = torch.distributed
        group = mesh.get_group("pod")

        def train_step(params, opt_state, batch):
            n_pods, pod = dist.get_world_size(group), dist.get_rank(group)
            local = {}
            for k, v in batch.items():
                if v.shape[0] % n_pods:
                    raise ValueError(f"batch {k!r} of {v.shape[0]} rows does "
                                     f"not split over {n_pods} pods")
                rows = v.shape[0] // n_pods
                local[k] = v.narrow(0, pod * rows, rows)
            loss, grads = local_grads(params, local)
            grads = anycost_gradient_sync(grads, "pod", keep_frac=keep_frac,
                                          group=group)
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            loss = loss / n_pods
            params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss

        return train_step

    raise ValueError(grad_sync)


def make_prefill_step(model: Model, *, causal_skip: bool = False):
    def prefill_step(params, batch):
        return model.forward(params, batch, remat="none",
                             causal_skip=causal_skip)

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, batch):
        return model.decode(params, cache, batch)

    return serve_step
