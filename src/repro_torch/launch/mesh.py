"""Device meshes over the ranks of a ``torch.distributed`` process group.

The reference's meshes (``repro/launch/mesh.py``) name the axes of its
TPU devices; here each mesh is a ``DeviceMesh`` over the ranks of the
initialised default group, one rank per device (or pod), and an axis's
group is ``mesh.get_group(name)``.  Every function needs that group and
raises without it: a mesh is never made over a world of one by default.
Nothing here runs at import.  The mesh's device type follows the group's
backend: ``cuda`` under NCCL, ``cpu`` under gloo, which also carries
CUDA tensors (several ranks on one card).
"""
from __future__ import annotations

import math

import torch


def _world_size() -> int:
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs an initialised torch.distributed process "
            "group (one rank per device); call "
            "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh(shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import DeviceMesh
    kind = "cuda" if torch.distributed.get_backend() == "nccl" else "cpu"
    return DeviceMesh(kind, torch.arange(math.prod(shape)).view(shape),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, data_par: int = 16):
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
    return _mesh(shape, axes)


def make_host_mesh():
    """Every rank as a ``(1, world)`` ("data", "model") mesh."""
    return _mesh((1, _world_size()), ("data", "model"))


def make_pod_mesh(n: int | None = None):
    """The ("pod",) mesh of the ``"anycost"`` train step: one rank a pod,
    ``n`` pods (the group's size, which ``n`` must equal when given)."""
    world = _world_size()
    if n is not None and n != world:
        raise RuntimeError(f"{n} pods need {n} ranks; the process group has "
                           f"{world}")
    return _mesh((world,), ("pod",))


def describe(mesh) -> str:
    return " x ".join(f"{k}={v}"
                      for k, v in zip(mesh.mesh_dim_names, mesh.shape))
