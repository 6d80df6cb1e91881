"""Device meshes over the ranks of a ``torch.distributed`` process group.

The reference's meshes (``repro/launch/mesh.py``) name the axes of its
TPU devices; here each mesh is a ``DeviceMesh`` over the ranks of the
initialised default group, one rank per device (or pod), and an axis's
group is ``mesh.get_group(name)``.  Every function needs that group and
raises without it: a mesh is never made over a world of one by default.
Nothing here runs at import.

A mesh's device type is where its ranks compute, and it is where a
``DTensor`` over the mesh places its shards: ``device`` names it, and by
default it is ``cuda`` under NCCL, and under gloo (which also carries
CUDA tensors, for several ranks on one card) ``cuda`` when the process
sees a card and ``cpu`` when it does not.

DTensor moves data with the functional collectives
(``torch.ops._c10d_functional``), and under gloo those crash on CUDA
tensors in torch 2.11 (a segfault in the first ``all_gather``), where
gloo's own synchronous collectives run.  So on that torch a ``cuda`` mesh
over a gloo group first registers, for CUDA tensors, kernels of the four
functional collectives DTensor issues that call the synchronous ones
(:func:`sync_functional_collectives`): the same values, issued and
waited at once.  The registration is process-wide and stays: every
functional collective on a CUDA tensor in that process takes the
synchronous route from then on, over an NCCL group made later too (the
same values, each collective waited before it returns).
"""
from __future__ import annotations

import math

import torch

_SYNC_LIBS: dict = {}

# torch releases whose functional collectives crash on CUDA tensors under
# gloo (module docstring)
_GLOO_CUDA_CRASH = ("2.11",)


def _world_size() -> int:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs an initialised torch.distributed process "
            "group (one rank per device); call "
            "torch.distributed.init_process_group first")
    return dist.get_world_size()


def device_type(device=None) -> str:
    """The device type of a mesh over the initialised group's ranks
    (module docstring)."""
    if device is not None:
        return torch.device(device).type
    if torch.distributed.get_backend() == "nccl":
        return "cuda"
    return "cuda" if torch.cuda.is_available() else "cpu"


def sync_functional_collectives(dispatch_key: str = "CUDA") -> None:
    """Register, for tensors of ``dispatch_key``, kernels of the
    functional ``all_gather_into_tensor``, ``all_reduce``,
    ``reduce_scatter_tensor`` and ``all_to_all_single`` that run gloo's
    synchronous collectives (module docstring).  Once a process and key;
    gloo has no average, so ``avg`` is a sum divided by the group size,
    and raises on an integer tensor rather than truncate it."""
    if dispatch_key in _SYNC_LIBS:
        return
    dist = torch.distributed
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN,
           "product": dist.ReduceOp.PRODUCT}

    def check(inp, reduce_op):
        if reduce_op.lower() == "avg" and not (inp.is_floating_point()
                                               or inp.is_complex()):
            raise TypeError(f"an 'avg' reduction of a {inp.dtype} tensor; "
                            f"gloo has no average, and a sum divided by the "
                            f"group size would truncate it")

    def finish(out, reduce_op, group):
        if reduce_op.lower() == "avg":
            out.div_(dist.get_world_size(group))
        return out

    def all_gather_into_tensor(inp, group_size, group_name):
        out = inp.new_empty((group_size * inp.shape[0],) + inp.shape[1:])
        dist.all_gather_into_tensor(out, inp.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out

    def all_reduce(inp, reduce_op, group_name):
        check(inp, reduce_op)
        group = _resolve_process_group(group_name)
        out = inp.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=ops[reduce_op.lower()], group=group)
        return finish(out, reduce_op, group)

    def reduce_scatter_tensor(inp, reduce_op, group_size, group_name):
        check(inp, reduce_op)
        group = _resolve_process_group(group_name)
        out = inp.new_empty((inp.shape[0] // group_size,) + inp.shape[1:])
        dist.reduce_scatter_tensor(out, inp.contiguous(),
                                   op=ops[reduce_op.lower()], group=group)
        return finish(out, reduce_op, group)

    def all_to_all_single(inp, output_split_sizes, input_split_sizes,
                          group_name):
        out = inp.new_empty((sum(output_split_sizes),) + inp.shape[1:])
        dist.all_to_all_single(out, inp.contiguous(),
                               list(output_split_sizes),
                               list(input_split_sizes),
                               group=_resolve_process_group(group_name))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for fn in (all_gather_into_tensor, all_reduce, reduce_scatter_tensor,
               all_to_all_single):
        lib.impl(fn.__name__, fn, dispatch_key)
    _SYNC_LIBS[dispatch_key] = lib


def make_mesh(shape: tuple, axes: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over ranks 0.. in
    row-major order, the counterpart of ``jax.make_mesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if device_type(device) == "cuda" \
            and torch.distributed.get_backend() == "gloo" \
            and torch.__version__.startswith(_GLOO_CUDA_CRASH):
        sync_functional_collectives("CUDA")
    return DeviceMesh(device_type(device),
                      torch.arange(math.prod(shape)).view(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, data_par: int = 16,
                         device=None):
    """The reference's TPU v5e layout: 256 devices a pod, split ``data_par``
    by ``256 // data_par`` over ("data", "model"), and two pods in front
    under ``multi_pod``.  Raises unless the process group has exactly that
    many ranks (256, or 512 with ``multi_pod``)."""
    model_par = 256 // data_par
    if data_par * model_par != 256:
        raise ValueError(f"data_par must divide 256; got {data_par}")
    shape = (2, data_par, model_par) if multi_pod else (data_par, model_par)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    world = _world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"the production mesh {dict(zip(axes, shape))} "
                           f"needs {math.prod(shape)} ranks; the process "
                           f"group has {world}")
    return make_mesh(shape, axes, device)


def make_host_mesh(device=None):
    """Every rank as a ``(1, world)`` ("data", "model") mesh."""
    return make_mesh((1, _world_size()), ("data", "model"), device)


def make_pod_mesh(n: int | None = None, device=None):
    """The ("pod",) mesh of the ``"anycost"`` train step: one rank a pod,
    ``n`` pods (the group's size, which ``n`` must equal when given)."""
    world = _world_size()
    if n is not None and n != world:
        raise RuntimeError(f"{n} pods need {n} ranks; the process group has "
                           f"{world}")
    return make_mesh((world,), ("pod",), device)


def make_anycost_mesh(n_pods: int | None = None, device=None):
    """The ("pod", "data", "model") mesh of the sharded ``"anycost"``
    train step: ``n_pods`` pods (default: every rank a pod), each pod's
    ranks a ``(1, world / n_pods)`` data/model block."""
    world = _world_size()
    n_pods = world if n_pods is None else n_pods
    if n_pods < 1 or world % n_pods:
        raise RuntimeError(f"{n_pods} pods do not split the process "
                           f"group's {world} ranks")
    return make_mesh((n_pods, 1, world // n_pods), ("pod", "data", "model"),
                     device)


def describe(mesh) -> str:
    return " x ".join(f"{k}={v}"
                      for k, v in zip(mesh.mesh_dim_names, mesh.shape))
