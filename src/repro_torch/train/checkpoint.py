"""Checkpoints of nested dicts of tensors in the reference's file format
(``repro/train/checkpoint.py``): ``arrays.npz`` with each leaf under its
``/``-joined path, ``/`` written as ``__``, and ``manifest.json`` with
``step``, ``extra`` and, per path, the leaf's ``dtype`` and ``shape``.

bfloat16 leaves are stored as their 16-bit pattern (a ``uint16`` view),
so a checkpoint written by either package loads in the other bit for bit.
Leaves may be tensors on any device; they load as CPU tensors.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.utils.pytree import PyTree


def _flatten(tree: PyTree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict) -> PyTree:
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def _array(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the array to store, the manifest's dtype name)."""
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree: PyTree, step: int = 0,
                    extra: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    arrays = {}
    manifest = {"step": step, "extra": extra or {}, "entries": {}}
    for k, v in _flatten(tree).items():
        arr, dtype = _array(v)
        manifest["entries"][k] = {"dtype": dtype, "shape": list(arr.shape)}
        arrays[k.replace("/", "__")] = arr
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def load_checkpoint(path: str) -> tuple[PyTree, int, dict]:
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    flat = {}
    for k, meta in manifest["entries"].items():
        arr = data[k.replace("/", "__")]
        if meta["dtype"] == "bfloat16":
            flat[k] = torch.from_numpy(arr.view(np.int16)).view(
                torch.bfloat16)
        else:
            flat[k] = torch.from_numpy(arr)
    return _unflatten(flat), manifest["step"], manifest["extra"]
