"""Step functions, input specs and shardings for the trainer, the server
and the dry-run.

  train_step(params, opt_state, batch)   -> (params, opt_state, loss)
  prefill_step(params, batch)            -> logits        (prefill)
  serve_step(params, cache, batch)       -> (logits, cache)  (1-token decode)

The train step writes the parameters and the optimizer state in place
(``train/optimizer.py``) and returns them with the loss, a tensor on the
device.  ``grad_sync``:
  "auto"     the step on the parameters as they are: plain tensors on
             one device, or ``DTensor``s placed by :func:`param_shardings`
             under an active ``sharding.use_sharding`` context, where the
             batch is placed by its logical axes and the model's ``lc``
             constraints redistribute the activations.  On a mesh with
             pods each pod takes its block of the batch and the gradients
             and the loss are averaged over the pods (what GSPMD reduces
             over the reference's "pod" axis; ``sharding.py``).
  "anycost"  each pod takes its block of the batch, and the gradients
             are synced with the compressed collective
             (``core/distributed.py``) over the mesh's "pod" group; under
             a context the "data" and "model" dimensions stay DTensor
             placements inside each pod, the counterpart of the
             reference's partial-manual ``shard_map``.

The sharding helpers (:func:`param_shardings`, :func:`opt_state_shardings`,
:func:`batch_shardings`, :func:`cache_shardings`) need an active context
and give ``sharding.NamedSharding``s whose specs equal the reference's;
:func:`distribute` places real tensors by them, and
:func:`make_step_and_args` gives a step with its arguments as ``meta``
tensors for the dry-run (``launch/dryrun.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core.distributed import (anycost_gradient_sync,
                                          mean_gradient_sync)
from repro_torch.models.registry import Model, loss_fn
from repro_torch.train.optimizer import Optimizer
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten


# -------------------------------------------------------------- input specs

#: the logical axes of each batch entry
BATCH_AXES = {"tokens": ("batch", "seq"),
              "patch_embeds": ("batch", "patches", "embed"),
              "frames": ("batch", "frames", "embed")}


def batch_logical_axes(cfg: ArchConfig, shape: InputShape) -> dict:
    keys = ["tokens"]
    if cfg.family == "vlm" and shape.kind != "decode":
        keys.append("patch_embeds")
    if cfg.family == "encdec" and shape.kind != "decode":
        keys.append("frames")
    return {k: BATCH_AXES[k] for k in keys}


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


def abstract_cache(model: Model, shape: InputShape):
    """The decode cache as ``meta`` tensors (``pos`` stays an int)."""
    return model.init_cache(shape.global_batch, shape.seq_len, "meta")


# --------------------------------------------------------------- shardings

def param_shardings(model: Model):
    """The parameters' shardings (needs an active sharding context)."""
    return tree_map(lambda ax, s: shd.sharding_for(s.shape, ax.names),
                    model.logical_axes(), model.abstract_params())


def opt_state_shardings(opt: Optimizer, model: Model):
    """The moments take their parameters' shardings, the rest (``step``)
    is replicated."""
    pshard = param_shardings(model)
    return {k: pshard if k in ("m", "v") else shd.sharding_for((), ())
            for k in opt.init(model.abstract_params())}


def batch_shardings(cfg: ArchConfig, shape: InputShape):
    specs = input_specs(cfg, shape)
    axes = batch_logical_axes(cfg, shape)
    return {k: shd.sharding_for(specs[k].shape, axes[k]) for k in specs}


def _cache_leaf_axes(path: str, ndim: int) -> tuple:
    """Structural logical axes of KV/state cache leaves (stacked layers)."""
    last = path.split(".")[-1]
    if last == "pos":
        return ()
    if last == "k_pos":
        return ("layers", "cache_seq")[-ndim:]
    if last in ("k", "v"):
        return ("layers", "batch", "cache_seq", "kv_heads",
                "head_dim")[-ndim:]
    if last == "h":                       # ssm (L,B,di,N) vs rglru (L,B,W)
        return ("layers", "batch", "inner_act", "state") if ndim == 4 \
            else ("layers", "batch", "inner_act")[-ndim:]
    if last == "conv":
        return ("layers", "batch", None, "inner_act")[-ndim:]
    return tuple([None] * ndim)


def cache_shardings(model: Model, shape: InputShape):
    """The decode cache's shardings; the int ``pos`` gets the replicated
    scalar sharding of the reference's 0-d ``pos``."""
    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}{k}.") for k, v in tree.items()}
        if not isinstance(tree, torch.Tensor):
            return shd.sharding_for((), ())
        return shd.sharding_for(tree.shape,
                                _cache_leaf_axes(prefix[:-1], tree.ndim))

    return walk(abstract_cache(model, shape))


def grads_spec(model: Model):
    return model.abstract_params()


def _dtensor(local: torch.Tensor, sharding):
    """A ``DTensor`` of this rank's shard ``local`` (every spec divides its
    dimensions, ``sharding.safe_spec``)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, sharding.mesh, sharding.placements,
                              run_check=False)


def distribute(tree, shardings):
    """Each tensor leaf as a ``DTensor`` with its sharding's placements
    (on the mesh's device), cut first to this pod's block where its spec
    names "pod" (``sharding.pod_block``); a leaf whose sharding is None,
    or that is no tensor, stays as it is.  Every rank must hold the whole
    leaf, the same on each (a seeded initialisation or batch): each keeps
    its own shard, copied, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    def one(t, s):
        if s is None or not isinstance(t, torch.Tensor) \
                or shd.is_dtensor(t):
            return t
        t = shd.pod_block(t, s.spec)
        d = distribute_tensor(t.detach(), s.mesh, s.placements,
                              src_data_rank=None)
        local = d.to_local()
        if local.numel() < t.numel() and not t.is_meta and \
                local.untyped_storage().data_ptr() \
                == t.untyped_storage().data_ptr():
            # a view of the whole leaf would keep all of it alive
            d = _dtensor(local.clone(), s)
        return d

    return tree_map(one, tree, shardings)


def meta_dtensors(tree, shardings):
    """The dry-run's arguments: each ``meta`` leaf as a ``DTensor`` whose
    local shard is a ``meta`` tensor of this rank's shard shape."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    def one(t, s):
        if s is None or not isinstance(t, torch.Tensor):
            return t
        t = shd.pod_block(t, s.spec)
        local_shape, _ = compute_local_shape_and_global_offset(
            t.shape, s.mesh, s.placements)
        return _dtensor(torch.empty(local_shape, dtype=t.dtype,
                                    device="meta"), s)

    return tree_map(one, tree, shardings)


def place_batch(batch: dict) -> dict:
    """Under an active context, each plain batch tensor as a ``DTensor``
    placed by its logical axes; the batch as it is otherwise."""
    if not shd.active():
        return batch
    return {k: distribute(v, shd.sharding_for(v.shape, BATCH_AXES[k]))
            for k, v in batch.items()}


# ------------------------------------------------------------------- steps

def _implicit_replication():
    """Plain tensors that the model makes on the fly (positions, masks,
    RoPE angles) meet ``DTensor``s as replicated values."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def value_and_grad(model: Model, params, batch, **kw):
    """(loss, grads): the loss on ``batch`` and its gradient with respect
    to every parameter leaf, in the parameters' tree and dtypes (a leaf
    the loss does not reach gets zeros, as ``jax.value_and_grad`` gives
    it).  ``kw`` goes to the model's forward (``remat``,
    ``causal_skip``).  The loss is detached and stays on the device.

    On ``DTensor`` parameters the loss is the whole (replicated) value,
    a plain tensor, and each gradient leaf takes its parameter's
    placements."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    if not any(shd.is_dtensor(p) for p in leaves):
        loss = loss_fn(model, tree_unflatten(params, leaves), batch, **kw)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), tree_unflatten(params, grads)
    with _implicit_replication():
        loss = loss_fn(model, tree_unflatten(params, leaves), batch, **kw)
        if shd.is_dtensor(loss):
            loss = loss.full_tensor()
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if tuple(g.placements) != tuple(p.placements) else g
                 for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, opt: Optimizer, *, remat: str = "full",
                    causal_skip: bool = False, grad_sync: str = "auto",
                    keep_frac: float = 1.0 / 16.0, mesh=None):
    """The reference's train step: the loss and gradients under ``remat``
    (``"full"``, ``"dots"`` or ``"none"``), then ``opt.update`` in place.

    Under an active sharding context the parameters and the optimizer
    state are ``DTensor``s (:func:`distribute` by
    :func:`param_shardings` and :func:`opt_state_shardings`), and the
    step is called inside the context: the batch, given whole on every
    rank, is placed by its logical axes.

    ``grad_sync="anycost"`` needs ``mesh``, a ``DeviceMesh`` with a "pod"
    dimension (``launch/mesh.make_pod_mesh``, or under a context
    ``make_anycost_mesh``).  Every rank is given the global batch and
    takes its contiguous block of the leading axis by its pod rank (the
    reference's ``P("pod")`` in_spec); its gradients are synced in place
    with ``anycost_gradient_sync`` at ``keep_frac``, each sharded leaf
    shard by shard (``axes_tree``), the loss is averaged over the pods,
    and every pod makes the same update."""
    def local_grads(params, batch):
        return value_and_grad(model, params, place_batch(batch),
                              remat=remat, causal_skip=causal_skip)

    if grad_sync == "auto":
        def train_step(params, opt_state, batch):
            loss, grads = local_grads(params, batch)
            pods = shd.pod_group()
            if pods is not None:
                grads = mean_gradient_sync(grads, group=pods)
                torch.distributed.all_reduce(loss, group=pods)
                loss = loss / shd.pod_size()
            with _implicit_replication():
                params, opt_state = opt.update(params, grads, opt_state)
            return params, opt_state, loss

        return train_step

    if grad_sync == "anycost":
        if mesh is None:
            raise ValueError("anycost sync needs the mesh")
        dist = torch.distributed
        group = mesh.get_group("pod")
        axes_tree = model.logical_axes()

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
                                          group=group, axes_tree=axes_tree)
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
            loss = loss / n_pods
            with _implicit_replication():
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


# ----------------------------------------------------- dry-run entry points

def rules_for(shape: InputShape, grad_sync: str = "auto") -> dict:
    """Per-shape logical-rule overrides, the reference's."""
    rules = {}
    if grad_sync == "anycost":
        # the pod axis is the sync's: no logical rule may name it
        rules["batch"] = "data"
        # the reference replicates the embedding's vocab dimension inside
        # its partial-manual region and shards the feature dimension
        rules["vocab"] = None
        rules["embed_fsdp"] = "model"
    if shape.kind == "decode":
        # weight-stationary expert sharding for inference
        rules.update({"expert_in": None, "expert_ff": "data"})
    if shape.kind == "decode" and shape.global_batch == 1:
        # batch unshardable: the data axis goes to the KV cache sequence
        rules.update({"batch": None, "cache_seq": "data"})
    return rules


def make_step_and_args(model: Model, opt: Optional[Optimizer],
                       shape: InputShape, *, remat: str = "full",
                       causal_skip: bool = False, grad_sync: str = "auto",
                       keep_frac: float = 1.0 / 16.0, mesh=None):
    """(step, args, in_shardings, out_shardings): ``args`` are ``DTensor``s
    over ``meta`` shards placed by the in-shardings (the ``"anycost"``
    batch enters whole, plain, and each pod takes its block, the
    in-sharding's ``P("pod")``).

    Must be called inside ``sharding.use_sharding(mesh, rules_for(shape,
    grad_sync))``, and the step called inside it too."""
    cfg = model.cfg
    batch = input_specs(cfg, shape)
    if grad_sync == "anycost":
        # the reference's P("pod") in_spec; the step is given the batch
        # whole and takes its pod's block itself
        replicated = shd.sharding_for((), ())
        bshard = {k: replicated._replace(spec=shd.P("pod"))
                  for k in batch}
        batch_args = batch
    else:
        bshard = batch_shardings(cfg, shape)
        batch_args = meta_dtensors(batch, bshard)
    pshard = param_shardings(model)
    params_abs = meta_dtensors(model.abstract_params(), pshard)
    if shape.kind == "train":
        if opt is None:
            raise ValueError("a train step needs an optimizer")
        step = make_train_step(model, opt, remat=remat,
                               causal_skip=causal_skip, grad_sync=grad_sync,
                               keep_frac=keep_frac, mesh=mesh)
        oshard = opt_state_shardings(opt, model)
        opt_abs = meta_dtensors(opt.init(model.abstract_params()), oshard)
        args = (params_abs, opt_abs, batch_args)
        in_sh = (pshard, oshard, bshard)
        out_sh = (pshard, oshard, shd.sharding_for((), ()))
        return step, args, in_sh, out_sh
    if shape.kind == "prefill":
        prefill = make_prefill_step(model, causal_skip=causal_skip)

        def step(params, batch):
            with _implicit_replication():
                return prefill(params, batch)

        logits_sh = shd.sharding_for(
            (shape.global_batch, shape.seq_len, cfg.vocab_size),
            ("batch", "seq", "vocab_act"))
        return step, (params_abs, batch_args), (pshard, bshard), logits_sh
    if shape.kind == "decode":
        serve = make_serve_step(model)

        def step(params, cache, batch):
            with _implicit_replication():
                return serve(params, cache, batch)

        cshard = cache_shardings(model, shape)
        cache_abs = meta_dtensors(abstract_cache(model, shape), cshard)
        logits_sh = shd.sharding_for(
            (shape.global_batch, 1, cfg.vocab_size),
            ("batch", "seq", "vocab_act"))
        return step, (params_abs, cache_abs, batch_args), \
            (pshard, cshard, bshard), (logits_sh, cshard)
    raise ValueError(shape.kind)
