"""Parameters as numpy, in and out of the port.

The JAX package's params leave it as nested dicts of numpy arrays
(``np.asarray`` of each leaf); these two functions carry such a tree
into the port on a device and back, keeping the reference's layouts and
every leaf's dtype.  A bfloat16 leaf arrives as an array of the
``bfloat16`` dtype that ``ml_dtypes`` registers with numpy; numpy and
torch share no such dtype, so it crosses as its 16-bit pattern, bit for
bit.  The dtype is recognised by name, so the port never imports
``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import PyTree, tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.tensor(a.view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    return torch.tensor(a, device=device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        try:
            bf16 = np.dtype("bfloat16")
        except TypeError as e:
            raise TypeError(
                "a bfloat16 leaf needs numpy's bfloat16 dtype, which "
                "ml_dtypes registers when it is imported (JAX imports "
                "it)") from e
        return t.view(torch.int16).numpy().view(bf16)
    return t.numpy()


def params_from_numpy(tree: PyTree, device) -> PyTree:
    """Nested dict of arrays -> nested dict of tensors on ``device``
    (copied, dtypes kept, bfloat16 bit for bit)."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Nested dict of tensors -> nested dict of numpy arrays (bfloat16
    leaves as numpy's ``bfloat16`` dtype, bit for bit)."""
    return tree_map(_to_numpy, tree)
