"""Parameter init and the building blocks of the CNN and LM families.

Parameters are nested dicts of tensors, with the reference's layouts
(``repro/models/layers.py``): linear ``w`` is ``(in, out)``, an
embedding table ``(vocab, d)``.  ``param`` follows the reference's
``layers.param``: ``normal`` draws N(0, 1) scaled by
``scale / sqrt(fan_in)`` with ``fan_in`` the product of all but the last
axis of one layer's leaf; ``embed`` draws N(0, 1) times ``scale``;
``uniform`` draws U(-scale, scale); ``zeros`` and ``ones`` are constant.
Draws are float32, on the device of the caller's seeded
``torch.Generator``, and then cast to the parameter dtype, so a seed
gives the same parameters wherever the generator lives.  Torch cannot
reproduce the reference's threefry stream, so tests that need the
reference's own parameters carry them over with ``repro_torch.bridge``.

The LM primitives keep the reference's cast points: each product runs
in the activation dtype (``x @ w.to(x.dtype)``); the norms, RoPE and
(unless ``bf16``) the unembedding compute in float32.

Every parameter also carries the reference's *logical axes*, one name a
dimension (``param``'s ``axes``): :func:`logical_axes` runs an init
function in an axes mode that returns a :class:`LogicalAxes` for each
leaf, and :func:`abstract_params` in a shape mode that returns a
``meta`` tensor (shape and dtype, no storage), the counterpart of the
reference's ``ShapeDtypeStruct``.  Neither mode draws from a generator,
so both take ``None`` for it and leave a seeded initialisation as it
is.  ``launch/steps`` and ``sharding`` turn the axes into placements.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.sharding import lc


class LogicalAxes:
    """A tree leaf holding one logical axis name (or None) a dimension."""

    __slots__ = ("names",)

    def __init__(self, names):
        self.names = tuple(names)

    def prepend(self, name: str) -> "LogicalAxes":
        return LogicalAxes((name,) + self.names)

    def __repr__(self):
        return f"Axes{self.names}"

    def __eq__(self, other):
        return isinstance(other, LogicalAxes) and self.names == other.names

    def __hash__(self):
        return hash(self.names)


class _Mode(threading.local):
    def __init__(self):
        self.axes_mode = False
        self.shape_mode = False


_MODE = _Mode()


@contextlib.contextmanager
def _mode(name: str):
    prev = getattr(_MODE, name)
    setattr(_MODE, name, True)
    try:
        yield
    finally:
        setattr(_MODE, name, prev)


def abstract_mode() -> bool:
    """True inside :func:`logical_axes` or :func:`abstract_params`."""
    return _MODE.axes_mode or _MODE.shape_mode


def param(gen: Optional[torch.Generator], shape: Sequence[int],
          axes: Sequence[Optional[str]], init: str = "normal",
          scale: float = 1.0, dtype=torch.float32):
    """One parameter leaf; in the axes mode its :class:`LogicalAxes`, in
    the shape mode a ``meta`` tensor of its shape and dtype."""
    shape = tuple(shape)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {tuple(axes)} differ in "
                         f"rank")
    if _MODE.axes_mode:
        return LogicalAxes(axes)
    if _MODE.shape_mode:
        return torch.empty(shape, dtype=dtype, device="meta")
    dev = gen.device
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if init == "normal":
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else max(shape[0], 1)
        std = scale / math.sqrt(fan_in)
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * std).to(dtype)
    if init == "embed":
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=dev) * scale).to(dtype)
    if init == "uniform":
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=dev)
        return (u * (2 * scale) - scale).to(dtype)
    raise ValueError(init)


def logical_axes(init_fn: Callable, *args, **kwargs):
    """The tree of :class:`LogicalAxes` of ``init_fn(gen, ...)``'s
    parameters (``init_fn`` is called with ``None`` for the generator)."""
    with _mode("axes_mode"):
        return init_fn(None, *args, **kwargs)


def abstract_params(init_fn: Callable, *args, **kwargs):
    """The tree of ``meta`` tensors of ``init_fn(gen, ...)``'s parameters:
    shapes and dtypes, no storage."""
    with _mode("shape_mode"):
        return init_fn(None, *args, **kwargs)


# ---------------------------------------------------------------- primitives

def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, scale: float = 1.0,
                dtype=torch.float32, axes=("fsdp", "tp")) -> dict:
    """``w`` is ``(in, out)``, as in the reference."""
    p = {"w": param(gen, (d_in, d_out), axes, "normal", scale, dtype)}
    if bias:
        p["b"] = param(gen, (d_out,), (axes[1],), "zeros", dtype=dtype)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_norm(gen: torch.Generator, d: int, *, kind: str = "rmsnorm",
              dtype=torch.float32) -> dict:
    p = {"scale": param(gen, (d,), ("embed",), "ones", dtype=dtype)}
    if kind == "layernorm":
        p["bias"] = param(gen, (d,), ("embed",), "zeros", dtype=dtype)
    return p


def norm(p: dict, x: torch.Tensor, *, kind: str = "rmsnorm",
         eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    elif kind == "none":
        y = xf
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32) -> dict:
    # the table's own logical axes, which the "anycost" rules remap
    # (launch/steps.rules_for) without touching the other leaves
    return {"table": param(gen, (vocab, d), ("vocab", "embed_fsdp"),
                           "embed", 0.02, dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = p["table"]
    if _sharded(tokens) and not _sharded(table, 0):
        # a sharded batch into a table whole over its rows (the
        # "anycost" rules): DTensor's embedding strategy; torch 2.11's
        # index_select backward takes the local indices for the whole
        return F.embedding(tokens, table)
    rows = torch.index_select(table, 0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, table.shape[1])


def _sharded(x: torch.Tensor, dim=None) -> bool:
    """Whether a ``DTensor`` is split (on ``dim``, or on any dimension)."""
    return hasattr(x, "placements") and any(
        q.is_shard() and (dim is None or q.dim == dim)
        for q in x.placements)


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in float32, from the tied embedding table."""
    return x.float() @ p["table"].float().T


def head_logits(p_linear: dict, x: torch.Tensor, *,
                bf16: bool = False) -> torch.Tensor:
    """Unembedding product.  ``bf16=True`` computes it in the parameter
    dtype and upcasts afterwards; otherwise in float32.  Logits are
    float32 either way."""
    if bf16:
        return linear(p_linear, x).float()
    return linear(p_linear, x.float())


# ----------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Half-split rotation (not interleaved).  x: (..., seq, heads,
    head_dim); positions: (..., seq)."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)   # (half,)
    angles = positions[..., :, None].float() * freqs          # (..,S,half)
    cos = torch.cos(angles)[..., :, None, :]                  # (..,S,1,half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


# ------------------------------------------------------------------------ mlp

def init_mlp(gen: torch.Generator, d: int, d_ff: int, *,
             activation: str = "swiglu", dtype=torch.float32) -> dict:
    if activation in ("swiglu", "geglu"):
        return {
            "w_gate": param(gen, (d, d_ff), ("fsdp", "tp"), dtype=dtype),
            "w_up": param(gen, (d, d_ff), ("fsdp", "tp"), dtype=dtype),
            "w_down": param(gen, (d_ff, d), ("tp", "fsdp"), dtype=dtype),
        }
    return {
        "w_up": param(gen, (d, d_ff), ("fsdp", "tp"), dtype=dtype),
        "w_down": param(gen, (d_ff, d), ("tp", "fsdp"), dtype=dtype),
    }


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name in ("swiglu", "silu"):
        return F.silu(x)
    if name in ("geglu", "gelu"):
        # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def mlp(p: dict, x: torch.Tensor, *, activation: str = "swiglu"
        ) -> torch.Tensor:
    if "w_gate" in p:
        g = _act(activation, x @ p["w_gate"].to(x.dtype))
        h = g * (x @ p["w_up"].to(x.dtype))
    else:
        h = _act(activation, x @ p["w_up"].to(x.dtype))
    h = lc(h, ("batch", "seq", "mlp_act"))
    return h @ p["w_down"].to(x.dtype)
