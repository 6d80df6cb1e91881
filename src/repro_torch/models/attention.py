"""Attention: GQA/MQA/MHA with causal + sliding-window masks.

Three execution paths, as in the reference (``repro/models/attention.py``):

* ``attention_dense`` — materialized scores; sequences up to 2048.
* ``attention_blockwise`` — flash-style online softmax over blocks of
  queries and keys (Python loops where the reference scans); the
  ``causal_skip`` variant visits only the lower-triangular block pairs.
* ``attention_decode`` — one query token against a KV cache.

Scores, softmax and the value sum run in float32 (on the card with TF32
off, so outside the tensor cores); masked scores are ``NEG_INF``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch import sharding as shd
from repro_torch.sharding import lc

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv_heads: int, head_dim: int, *, qkv_bias: bool = False,
                   dtype=torch.float32) -> dict:
    return {
        "wq": L.init_linear(gen, d_model, n_heads * head_dim, bias=qkv_bias,
                            dtype=dtype, axes=("fsdp", "tp")),
        "wk": L.init_linear(gen, d_model, n_kv_heads * head_dim,
                            bias=qkv_bias, dtype=dtype, axes=("fsdp", "tp")),
        "wv": L.init_linear(gen, d_model, n_kv_heads * head_dim,
                            bias=qkv_bias, dtype=dtype, axes=("fsdp", "tp")),
        "wo": L.init_linear(gen, n_heads * head_dim, d_model, bias=False,
                            dtype=dtype, axes=("tp", "fsdp")),
    }


def qkv(p: dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
        n_kv_heads: int, head_dim: int, rope_theta: float,
        use_rope: bool = True):
    q = shd.split_last(L.linear(p["wq"], x), (n_heads, head_dim))
    k = shd.split_last(L.linear(p["wk"], x), (n_kv_heads, head_dim))
    v = shd.split_last(L.linear(p["wv"], x), (n_kv_heads, head_dim))
    if use_rope:
        q = L.apply_rope(q, positions, rope_theta)
        k = L.apply_rope(k, positions, rope_theta)
    q = lc(q, ("batch", "seq", "heads", "head_dim"))
    k = lc(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = lc(v, ("batch", "seq", "kv_heads", "head_dim"))
    return q, k, v


def _group(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """(B,S,H,hd) -> (B,S,Hkv,G,hd)."""
    B, S, H, hd = q.shape
    return q.reshape(B, S, n_kv_heads, H // n_kv_heads, hd)


def _scale(hd: int) -> float:
    """``1 / sqrt(hd)`` rounded as the reference's float32 computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """True where attention is allowed. q_pos:(Sq,), k_pos:(Sk,)."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _scores(qg: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """(B,Sq,Hkv,G,hd) x (B,Sk,Hkv,hd) -> float32 (B,Hkv,G,Sq,Sk)."""
    return shd.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) * scale


def attention_dense(q, k, v, q_pos, k_pos, *, causal=True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q:(B,Sq,H,hd) k/v:(B,Sk,Hkv,hd) -> (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    n_kv = k.shape[2]
    logits = _scores(_group(q, n_kv), k, _scale(hd))
    m = _mask(q_pos, k_pos, causal=causal, window=window)
    logits = torch.where(m[None, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = shd.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _block_update(acc, qi, kj, vj, qp, kp, scale, *, causal, window):
    """One online-softmax step of a query block against a key block.
    ``acc`` = (out (B,Hkv,G,bq,hd), row_max (B,Hkv,G,bq), denom)."""
    out, row_max, denom = acc
    logits = _scores(qi, kj, scale)
    m = _mask(qp, kp, causal=causal, window=window)
    logits = torch.where(m[None, None, None], logits, NEG_INF)
    new_max = torch.maximum(row_max, logits.amax(-1))
    correction = torch.exp(row_max - new_max)
    p = torch.exp(logits - new_max[..., None])
    denom = denom * correction + p.sum(-1)
    pv = shd.einsum("bkgqs,bskh->bkgqh", p, vj.float())
    out = out * correction[..., None] + pv
    return out, new_max, denom


def attention_blockwise(q, k, v, q_pos, k_pos, *, causal=True,
                        window: Optional[int] = None, block_q: int = 512,
                        block_kv: int = 512,
                        causal_skip: bool = False) -> torch.Tensor:
    """Flash-style attention. Shapes as :func:`attention_dense`.

    ``causal_skip=True`` visits only the (i, j<=i) block pairs instead of
    the full grid; it requires ``causal``, ``Sq == Sk`` and equal blocks.
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    n_kv = k.shape[2]
    G = H // n_kv
    block_q = min(block_q, Sq)
    block_kv = min(block_kv, Sk)
    if Sq % block_q or Sk % block_kv:
        raise ValueError(f"blocks ({block_q}, {block_kv}) do not divide "
                         f"the sequences ({Sq}, {Sk})")
    nq, nk = Sq // block_q, Sk // block_kv
    if causal_skip and not (causal and Sq == Sk and block_q == block_kv):
        raise ValueError("causal_skip needs causal attention, Sq == Sk and "
                         "square blocks")
    scale = _scale(hd)
    qg = _group(q, n_kv)                                   # (B,Sq,Hkv,G,hd)
    outs = []
    for i in range(nq):
        qs = slice(i * block_q, (i + 1) * block_q)
        acc = (torch.zeros((B, n_kv, G, block_q, hd), dtype=torch.float32,
                           device=q.device),
               torch.full((B, n_kv, G, block_q), NEG_INF,
                          dtype=torch.float32, device=q.device),
               torch.zeros((B, n_kv, G, block_q), dtype=torch.float32,
                           device=q.device))
        for j in range(i + 1 if causal_skip else nk):
            ks = slice(j * block_kv, (j + 1) * block_kv)
            acc = _block_update(acc, qg[:, qs], k[:, ks], v[:, ks],
                                q_pos[qs], k_pos[ks], scale, causal=causal,
                                window=window)
        out, _, denom = acc
        outs.append(out / torch.clamp(denom, min=1e-30)[..., None])
    out = torch.stack(outs, 0)                          # (nq,B,Hkv,G,bq,hd)
    out = out.permute(1, 0, 4, 2, 3, 5).reshape(B, Sq, n_kv, G, hd)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_decode(q, k_cache, v_cache, q_pos, k_pos, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token decode. q:(B,1,H,hd), caches:(B,T,Hkv,hd); an empty
    cache slot has ``k_pos`` -1."""
    B, _, H, hd = q.shape
    n_kv = k_cache.shape[2]
    logits = _scores(_group(q, n_kv), k_cache, _scale(hd))
    valid = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] >= 0)
    if window is not None:
        valid &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(valid[None, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = shd.einsum("bkgqs,bskh->bqkgh", w, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def attend(q, k, v, q_pos, k_pos, *, causal=True, window=None,
           blockwise_threshold: int = 2048,
           causal_skip: bool = False) -> torch.Tensor:
    """Dense up to ``blockwise_threshold`` tokens, blockwise above."""
    if q.shape[1] <= blockwise_threshold and k.shape[1] <= blockwise_threshold:
        return attention_dense(q, k, v, q_pos, k_pos, causal=causal,
                               window=window)
    return attention_blockwise(q, k, v, q_pos, k_pos, causal=causal,
                               window=window, causal_skip=causal_skip)


# ------------------------------------------------ the blocks' attention half

def attention_residual(p: dict, x: torch.Tensor, positions: torch.Tensor,
                       cfg, *, causal: bool = True,
                       causal_skip: bool = False):
    """``x + wo(attend(qkv(norm(x))))`` of one block ``p`` (its
    ``ln_attn`` and ``attn``), with the layer's new keys and values;
    ``causal=False`` for an encoder.  x:(B,S,D), positions:(B,S) ->
    (x, k (B,S,Hkv,hd), v)."""
    h = L.norm(p["ln_attn"], x, kind=cfg.norm)
    q, k, v = qkv(p["attn"], h, positions, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                  rope_theta=cfg.rope_theta)
    o = attend(q, k, v, positions[0], positions[0], causal=causal,
               window=cfg.sliding_window, causal_skip=causal_skip)
    B, S = x.shape[:2]
    x = lc(x + L.linear(p["attn"]["wo"], o.reshape(B, S, -1)),
           ("batch", "seq", "embed"))
    return x, k, v


def decode_residual(p: dict, x: torch.Tensor, cache: dict, pos: int,
                    cfg) -> torch.Tensor:
    """One-token decode of a block's attention half.  x:(B,1,D).

    Writes the token's key, value and position into the layer's cache in
    place, at slot ``pos % T`` under a sliding window and
    ``min(pos, T - 1)`` otherwise, as the reference's functional update
    does, then attends over the cache."""
    h = L.norm(p["ln_attn"], x, kind=cfg.norm)
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = qkv(p["attn"], h, positions, n_heads=cfg.n_heads,
                  n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
                  rope_theta=cfg.rope_theta)
    T = cache["k"].shape[1]
    slot = pos % T if cfg.sliding_window is not None else min(pos, T - 1)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["k_pos"][slot] = pos
    cache_axes = ("batch", "cache_seq", "kv_heads", "head_dim")
    o = attention_decode(q, lc(cache["k"], cache_axes),
                         lc(cache["v"], cache_axes), positions[0],
                         cache["k_pos"], window=cfg.sliding_window)
    return x + L.linear(p["attn"]["wo"], o.reshape(B, 1, -1))
