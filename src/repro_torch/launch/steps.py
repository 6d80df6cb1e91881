"""Step functions and input specs for the trainer and the server.

  train_step(params, opt_state, batch)   -> (params, opt_state, loss)
  prefill_step(params, batch)            -> logits        (prefill)
  serve_step(params, cache, batch)       -> (logits, cache)  (1-token decode)

The train step writes the parameters and the optimizer state in place
(``train/optimizer.py``) and returns them with the loss, a tensor on the
device.  ``grad_sync="auto"`` is the one-card step; the reference's
compressed ``"anycost"`` sync over a pod axis, its sharding helpers
(``param_shardings``, ``opt_state_shardings``, ``batch_shardings``,
``cache_shardings``, ``grads_spec``) and its per-shape rules
(``rules_for``, ``make_step_and_args``) arrive with the multi-card
slice (ROADMAP queue 1, item 5, 'Pod path' (c)).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, InputShape
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
    """The reference's train step on one device: the loss and gradients
    under ``remat`` (``"full"``, ``"dots"`` or ``"none"``), then
    ``opt.update`` in place.  ``keep_frac`` and ``mesh`` belong to the
    ``"anycost"`` sync, which is not ported."""
    if grad_sync == "anycost":
        raise NotImplementedError(
            "grad_sync='anycost' (the compressed gradient sync over a pod "
            "axis of several cards) arrives with ROADMAP queue 1, item 5, "
            "'Pod path' (c)")
    if grad_sync != "auto":
        raise ValueError(grad_sync)

    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch, remat=remat,
                                     causal_skip=causal_skip)
        params, opt_state = opt.update(params, grads, opt_state)
        return params, opt_state, loss

    return train_step


def make_prefill_step(model: Model, *, causal_skip: bool = False):
    def prefill_step(params, batch):
        return model.forward(params, batch, remat="none",
                             causal_skip=causal_skip)

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, batch):
        return model.decode(params, cache, batch)

    return serve_step
