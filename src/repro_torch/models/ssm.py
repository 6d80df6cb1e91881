"""Mamba-1 selective SSM block (the falcon-mamba family).

As in the reference (``repro/models/ssm.py``): the forward pass
evaluates the linear recurrence ``h_t = dA_t * h_{t-1} + dBx_t`` chunk
by chunk, ``SSM_CHUNK`` steps at a time, with an inclusive parallel
scan inside a chunk and the boundary state carried from one chunk to
the next; decode is the one-step recurrence over a (conv window, ssm
state) cache.

The scan inside a chunk is a Hillis-Steele scan of
:func:`_assoc_combine`: log2(chunk) doubling steps of tensor ops.  It
never divides by a cumulative product of ``dA`` (with ``A`` down to
``-N`` that product underflows over a chunk).  The reference's
``lax.associative_scan`` combines in another tree order, so the two
agree within float32 rounding, not bit for bit.  :func:`apply_block`
discretizes and reads out one chunk at a time, so only one chunk's
``(B, chunk, d_inner, N)`` float32 elements are alive at once (the
whole sequence's ``dA`` at falcon-mamba-7b's width, B=8, S=512, would
be 2.15 GB a layer).

Decode writes the layer's cache in place and returns the block's output.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch import sharding as shd
from repro_torch.sharding import lc

SSM_CHUNK = 128


def _dt_rank(cfg: ArchConfig) -> int:
    return cfg.ssm.dt_rank or max(1, -(-cfg.d_model // 16))


def init_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d, di, N = cfg.d_model, s.d_inner, s.state_dim
    dtr = _dt_rank(cfg)
    dt = cfg.param_dtype
    # S4D-real initialization for A; dt bias so softplus(dt) ~ U[1e-3, 0.1]
    if L.abstract_mode():
        # their axes and shapes, as the reference's mode branch gives them
        a_log = L.param(gen, (di, N), ("tp", "state"), "zeros")
        dt_bias = L.param(gen, (di,), ("tp",), "zeros")
    else:
        dev = gen.device
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev)).expand(di, N).clone()
        u = torch.rand((di,), generator=gen, dtype=torch.float32,
                       device=dev)
        dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                            + math.log(1e-3))
        # inverse softplus
        dt_bias = dt_init + torch.log(-torch.expm1(-dt_init))
    return {
        "norm": L.init_norm(gen, d, kind=cfg.norm, dtype=dt),
        "in_x": L.init_linear(gen, d, di, dtype=dt, axes=("fsdp", "tp")),
        "in_z": L.init_linear(gen, d, di, dtype=dt, axes=("fsdp", "tp")),
        "conv_w": L.param(gen, (s.conv_width, di), ("conv", "tp"), "normal",
                          dtype=dt),
        "conv_b": L.param(gen, (di,), ("tp",), "zeros", dtype=dt),
        "w_dt": L.init_linear(gen, di, dtr, dtype=dt, axes=("tp", "fsdp")),
        "w_B": L.init_linear(gen, di, N, dtype=dt, axes=("tp", "state")),
        "w_C": L.init_linear(gen, di, N, dtype=dt, axes=("tp", "state")),
        "dt_proj": L.init_linear(gen, dtr, di, dtype=dt,
                                 axes=("fsdp", "tp"), scale=dtr ** -0.5),
        "dt_bias": dt_bias,
        "A_log": a_log,
        "D": L.param(gen, (di,), ("tp",), "ones"),
        "out": L.init_linear(gen, di, d, dtype=dt, axes=("tp", "fsdp")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)`` (torch's ``F.softplus`` returns ``x`` above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x:(B,S,di), w:(width,di) -> (B,S,di); the
    taps accumulate in x's dtype, in tap order."""
    width, S = w.shape[0], x.shape[1]
    pad = shd.pad(x, (0, 0, width - 1, 0))
    y = torch.zeros_like(x)
    for kk in range(width):
        y = y + pad[:, kk:kk + S, :] * w[kk][None, None, :]
    return y + b[None, None, :]


def _dt_low_rank(p: dict, xh: torch.Tensor) -> torch.Tensor:
    """``linear(w_dt, xh) @ dt_proj``, xh:(B,S,di) -> (B,S,di).  On a
    ``DTensor`` both products run on the local shards
    (``sharding.einsum``): with the batch over "data" and the inner width
    over "model", torch 2.11's DTensor plans the second product with a
    ``S(0) -> P(sum)`` redistribution that it cannot run."""
    if not shd.is_dtensor(xh):
        return L.linear(p["w_dt"], xh) @ p["dt_proj"]["w"].to(xh.dtype)
    r = shd.einsum("bsd,dr->bsr", xh, p["w_dt"]["w"].to(xh.dtype))
    return shd.einsum("bsr,rd->bsd", r, p["dt_proj"]["w"].to(xh.dtype))


def _discretize(p: dict, xh: torch.Tensor):
    """xh:(B,S,di) -> float32 dt (B,S,di), B and C (B,S,N), A (di,N)."""
    dt = softplus(_dt_low_rank(p, xh) + p["dt_bias"].to(xh.dtype))
    Bm = L.linear(p["w_B"], xh).float()
    Cm = L.linear(p["w_C"], xh).float()
    A = -torch.exp(p["A_log"].float())
    return dt.float(), Bm, Cm, A


def _elements(dtf: torch.Tensor, xh: torch.Tensor, Bm: torch.Tensor,
              A: torch.Tensor):
    """The recurrence's elements (dA, dBx), each float32 (B,S,di,N)."""
    dA = torch.exp(dtf[..., None] * A[None, None])
    dBx = (dtf * xh.float())[..., None] * Bm[:, :, None, :]
    return dA, dBx


def _ssm_elements(p: dict, xh: torch.Tensor, cfg: ArchConfig):
    """Discretize: xh:(B,S,di) -> (dA, dBx) each (B,S,di,N), C:(B,S,N)."""
    dtf, Bm, Cm, A = _discretize(p, xh)
    dA, dBx = _elements(dtf, xh, Bm, A)
    return dA, dBx, Cm


def _assoc_combine(e1, e2):
    """(a1, b1) then (a2, b2): ``h -> a2 * (a1 * h + b1) + b2``."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def _scan_chunk(a: torch.Tensor, b: torch.Tensor, h: torch.Tensor):
    """One chunk of the recurrence from the carried state ``h``.
    a, b: (B,c,...); h: (B,...) -> every step's state (B,c,...).

    An inclusive scan of :func:`_assoc_combine` along axis 1 by doubling:
    after the step of distance d, element t holds the combination of
    elements t-2d+1..t."""
    c = a.shape[1]
    d = 1
    while d < c:
        a_new, b_new = _assoc_combine((a[:, :-d], b[:, :-d]),
                                      (a[:, d:], b[:, d:]))
        a = torch.cat([a[:, :d], a_new], dim=1)
        b = torch.cat([b[:, :d], b_new], dim=1)
        d *= 2
    return a * h[:, None] + b


def _chunk_len(S: int, chunk: int) -> int:
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence length {S} is not a multiple of the "
                         f"scan chunk {c}")
    return c


def chunked_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor,
                 chunk: int):
    """``h_t = a_t * h_{t-1} + b_t`` over axis 1, ``chunk`` steps at a
    time. a,b:(B,S,...); h0:(B,...) -> (h_seq (B,S,...), h_last)."""
    S = a.shape[1]
    c = _chunk_len(S, chunk)
    h_seq = torch.empty_like(b)
    h = h0
    for s in range(0, S, c):
        h_seq[:, s:s + c] = _scan_chunk(a[:, s:s + c], b[:, s:s + c], h)
        h = h_seq[:, s + c - 1]
    return h_seq, h


def ssm_scan(dA: torch.Tensor, dBx: torch.Tensor, h0: torch.Tensor):
    """Chunk-parallel linear recurrence. dA,dBx:(B,S,di,N); h0:(B,di,N)
    -> (h_seq (B,S,di,N), h_last (B,di,N))."""
    return chunked_scan(dA, dBx, h0, SSM_CHUNK)


def _scan_readout(p: dict, xh: torch.Tensor, h0: torch.Tensor):
    """``einsum(h_seq, C)`` of the recurrence over xh:(B,S,di), built and
    scanned one chunk at a time -> (float32 (B,S,di), h_last)."""
    B, S, di = xh.shape
    c = _chunk_len(S, SSM_CHUNK)
    dtf, Bm, Cm, A = _discretize(p, xh)
    # xh's placements on a DTensor (DTensor's new_empty follows its input)
    y = xh.new_empty((B, S, di), dtype=torch.float32)
    h = h0
    for s in range(0, S, c):
        sl = slice(s, s + c)
        dA, dBx = _elements(dtf[:, sl], xh[:, sl], Bm[:, sl], A)
        hs = _scan_chunk(dA, dBx, h)
        del dA, dBx
        y[:, sl] = torch.einsum("bsdn,bsn->bsd", hs, Cm[:, sl])
        h = hs[:, -1]
    return y, h


def _gate_out(p: dict, x: torch.Tensor, y: torch.Tensor, xc: torch.Tensor,
              z: torch.Tensor, *, constrain: bool = False) -> torch.Tensor:
    """``x + out((y + D xc) * silu(z))``, the sums in float32;
    ``constrain`` puts the forward pass's two sharding constraints on
    it."""
    y = y + p["D"].float() * xc.float()
    y = (y * F.silu(z.float())).to(x.dtype)
    if not constrain:
        return x + L.linear(p["out"], y)
    y = lc(y, ("batch", "seq", "inner_act"))
    return lc(x + L.linear(p["out"], y), ("batch", "seq", "embed"))


def apply_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, causal_skip: bool = False
                ) -> torch.Tensor:
    del positions, causal_skip
    s = cfg.ssm
    h = L.norm(p["norm"], x, kind=cfg.norm)
    xh = L.linear(p["in_x"], h)
    z = L.linear(p["in_z"], h)
    xh = lc(xh, ("batch", "seq", "inner_act"))
    xh = F.silu(_causal_conv(xh, p["conv_w"].to(xh.dtype),
                             p["conv_b"].to(xh.dtype)))
    h0 = torch.zeros((x.shape[0], s.d_inner, s.state_dim),
                     dtype=torch.float32, device=x.device)
    y, _ = _scan_readout(p, xh, h0)
    return _gate_out(p, x, y, xh, z, constrain=True)


def init_block_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     device) -> dict:
    del cache_len  # O(1) state: the whole point of an SSM
    s = cfg.ssm
    return {
        "h": torch.zeros((batch, s.d_inner, s.state_dim),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, s.d_inner),
                            dtype=cfg.param_dtype, device=device),
    }


def conv_step(cache: dict, xh: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """One step of the causal conv over the cached window: xh:(B,1,W) ->
    (B,W); the window advances in ``cache["conv"]`` in place."""
    window = torch.cat([cache["conv"].to(xh.dtype), xh], dim=1)
    out = torch.einsum("bwd,wd->bd", window, w.to(xh.dtype)) \
        + b.to(xh.dtype)
    cache["conv"].copy_(window[:, 1:])
    return out


def decode_block(p: dict, x: torch.Tensor, cache: dict, pos: int,
                 cfg: ArchConfig) -> torch.Tensor:
    """x:(B,1,D) one-step recurrence; writes the layer's cache in place."""
    del pos
    h = L.norm(p["norm"], x, kind=cfg.norm)
    xh = L.linear(p["in_x"], h)                          # (B,1,di)
    z = L.linear(p["in_z"], h)
    xc = F.silu(conv_step(cache, xh, p["conv_w"], p["conv_b"]))[:, None]
    dA, dBx, Cm = _ssm_elements(p, xc, cfg)
    h_new = dA[:, 0] * cache["h"] + dBx[:, 0]            # (B,di,N)
    cache["h"].copy_(h_new)
    y = torch.einsum("bdn,bn->bd", h_new, Cm[:, 0])
    return _gate_out(p, x, y[:, None], xc, z)
