"""Grouped bf16 GEMM over the routed experts, dropless.

Replaces no TPU kernel: the reference's MoE (``repro/models/moe.py``)
dispatches through a one-hot capacity einsum, and the port's
latent-attention MoE family (``models/mla_moe.py``) sorts its token x
top-k assignments by expert instead, so that each expert multiplies
exactly the rows routed to it.  Rows ``offs[g-1]:offs[g]`` of ``x`` form
group ``g`` (``offs`` the int32 running ends, ``offs[-1]`` the row
count); an empty group is allowed.  Three products, each one launch:

* :func:`grouped_mm` ``(M, k) x (G, k, n) -> (M, n)``, a group's rows by
  its own matrix (the forward, and the input gradient with the matrices
  transposed);
* :func:`grouped_mm_t` ``(M, k)^T x (M, n) -> (G, k, n)``, a group's
  rows of the first by its rows of the second (the weight gradient).

On the card both go to PyTorch's CUTLASS grouped GEMM for Hopper
(``torch._grouped_mm``: TMA loads and warp-specialised ``wgmma`` over
all groups in one persistent launch, with a small launch that lays out
the groups' pointers from ``offs`` on the device first, so no row count
is read on the host).  At DeepSeek-V2-Lite's widths (k 2048, n 1408, 64
groups) a product is bound by the tensor cores: ``2 M k n`` operations
over ``2 (M k + G k n + M n)`` bytes is some 900 operations a byte.  On
the CPU the plain versions loop over the groups.

Each launch adds to :data:`launches`: ``grouped_mm`` (launches),
``grouped_mm_macs`` (the multiply-adds, ``M k n`` for each of the three
products) and ``grouped_mm_elems`` (the elements read and written once:
``M k + G k n + M n`` for each).
"""
from __future__ import annotations

import torch

launches = {"grouped_mm": 0, "grouped_mm_macs": 0, "grouped_mm_elems": 0}


def _count(M: int, k: int, n: int, G: int) -> None:
    launches["grouped_mm"] += 1
    launches["grouped_mm_macs"] += M * k * n
    launches["grouped_mm_elems"] += M * k + G * k * n + M * n


def _check(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every operand must be on {dev} "
                             f"(CUDA); got {t.device}")
    if tensors[0].dtype != torch.bfloat16 or tensors[1].dtype \
            != torch.bfloat16:
        raise TypeError(f"{name}: the operands must be bfloat16; got "
                        f"{tensors[0].dtype}, {tensors[1].dtype}")
    if tensors[-1].dtype != torch.int32:
        raise TypeError(f"{name}: offs must be int32")


def grouped_mm(x: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """``x`` (M, k) bf16, ``w`` (G, k, n) bf16 (any strides a transpose of
    its last two dimensions gives), ``offs`` (G,) int32 -> (M, n) bf16."""
    _check("grouped_mm", x, w, offs)
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1] \
            or offs.shape != (w.shape[0],):
        raise ValueError(f"grouped_mm: expected x (M, k), w (G, k, n), offs "
                         f"(G,); got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(offs.shape)}")
    out = torch._grouped_mm(x, w, offs=offs)
    _count(x.shape[0], x.shape[1], w.shape[2], w.shape[0])
    return out


def grouped_mm_t(x: torch.Tensor, y: torch.Tensor,
                 offs: torch.Tensor) -> torch.Tensor:
    """``x`` (M, k) bf16, ``y`` (M, n) bf16, ``offs`` (G,) int32 -> (G, k,
    n) bf16: group ``g``'s ``x[rows].T @ y[rows]`` (zeros for an empty
    group)."""
    _check("grouped_mm_t", x, y, offs)
    if x.dim() != 2 or y.dim() != 2 or x.shape[0] != y.shape[0] \
            or offs.dim() != 1:
        raise ValueError(f"grouped_mm_t: expected x (M, k), y (M, n), offs "
                         f"(G,); got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(offs.shape)}")
    out = torch._grouped_mm(x.t(), y, offs=offs)
    _count(x.shape[0], x.shape[1], y.shape[1], offs.shape[0])
    return out


# ------------------------------------------------------------ plain versions

def _bounds(offs: torch.Tensor) -> list[tuple[int, int]]:
    ends = offs.tolist()
    return list(zip([0] + ends[:-1], ends))


def grouped_mm_ref(x: torch.Tensor, w: torch.Tensor,
                   offs: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_mm`, a product a group, in ``x``'s dtype."""
    out = x.new_empty((x.shape[0], w.shape[2]))
    for g, (a, b) in enumerate(_bounds(offs)):
        out[a:b] = x[a:b] @ w[g].to(x.dtype)
    return out


def grouped_mm_t_ref(x: torch.Tensor, y: torch.Tensor,
                     offs: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_mm_t`, a product a group, in ``x``'s dtype."""
    out = x.new_zeros((offs.shape[0], x.shape[1], y.shape[1]))
    for g, (a, b) in enumerate(_bounds(offs)):
        out[g] = x[a:b].T @ y[a:b]
    return out
