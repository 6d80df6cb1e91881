"""Parameter init and the linear layer.

Parameters are nested dicts of tensors.  ``param`` follows the
reference's ``layers.param``: ``normal`` draws N(0, 1) scaled by
``scale / sqrt(fan_in)`` with ``fan_in`` the product of all but the last
axis; ``zeros`` is all zeros.  Draws come from the caller's seeded
``torch.Generator`` on the CPU, so a seed gives the same parameters on
every device; torch cannot reproduce the reference's threefry stream,
so tests that need the reference's own parameters carry them over with
``repro_torch.bridge``.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch


def param(gen: torch.Generator, shape: Sequence[int], init: str = "normal",
          scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    shape = tuple(shape)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype)
    if init == "normal":
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else max(shape[0], 1)
        std = scale / math.sqrt(fan_in)
        return (torch.randn(shape, generator=gen, dtype=torch.float32)
                * std).to(dtype)
    raise ValueError(init)


def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, scale: float = 1.0) -> dict:
    """``w`` is ``(in, out)``, as in the reference."""
    p = {"w": param(gen, (d_in, d_out), "normal", scale)}
    if bias:
        p["b"] = param(gen, (d_out,), "zeros")
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y
