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
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F


def param(gen: torch.Generator, shape: Sequence[int], init: str = "normal",
          scale: float = 1.0, dtype=torch.float32) -> torch.Tensor:
    shape = tuple(shape)
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


# ---------------------------------------------------------------- primitives

def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, scale: float = 1.0,
                dtype=torch.float32) -> dict:
    """``w`` is ``(in, out)``, as in the reference."""
    p = {"w": param(gen, (d_in, d_out), "normal", scale, dtype)}
    if bias:
        p["b"] = param(gen, (d_out,), "zeros", dtype=dtype)
    return p


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def init_norm(gen: torch.Generator, d: int, *, kind: str = "rmsnorm",
              dtype=torch.float32) -> dict:
    p = {"scale": param(gen, (d,), "ones", dtype=dtype)}
    if kind == "layernorm":
        p["bias"] = param(gen, (d,), "zeros", dtype=dtype)
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
    return {"table": param(gen, (vocab, d), "embed", 0.02, dtype)}


def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    table = p["table"]
    rows = torch.index_select(table, 0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, table.shape[1])


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
            "w_gate": param(gen, (d, d_ff), dtype=dtype),
            "w_up": param(gen, (d, d_ff), dtype=dtype),
            "w_down": param(gen, (d_ff, d), dtype=dtype),
        }
    return {
        "w_up": param(gen, (d, d_ff), dtype=dtype),
        "w_down": param(gen, (d_ff, d), dtype=dtype),
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
    return h @ p["w_down"].to(x.dtype)
