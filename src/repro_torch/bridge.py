"""Parameters as numpy, in and out of the port.

The JAX package's params leave it as nested dicts of numpy arrays
(``np.asarray`` of each leaf); these two functions carry such a tree
into the port on a device and back, keeping the reference's layouts.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.pytree import PyTree, tree_map


def params_from_numpy(tree: PyTree, device) -> PyTree:
    """Nested dict of arrays -> nested dict of tensors on ``device``
    (copied, dtypes kept)."""
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=device),
                    tree)


def params_to_numpy(tree: PyTree) -> PyTree:
    """Nested dict of tensors -> nested dict of numpy arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
