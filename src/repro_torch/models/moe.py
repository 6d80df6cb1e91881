"""Mixture-of-Experts block: top-k router + capacity-based dispatch.

The reference's design (``repro/models/moe.py``): tokens reach the
experts through a one-hot capacity tensor, capacity is per (batch row,
chunk of ``MOE_CHUNK`` tokens), and an assignment past its expert's
capacity is dropped in cumsum order, (token, k) pairs counted token by
token.  The router stays float32 in a bf16 model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_residual,
                                          decode_residual, init_attention)
from repro_torch import sharding as shd
from repro_torch.sharding import lc

MOE_CHUNK = 512


def init_router(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"w": L.param(gen, (cfg.d_model, cfg.moe.n_experts),
                         ("fsdp", "experts"), "normal",
                         dtype=torch.float32)}


def init_experts(gen: torch.Generator, cfg: ArchConfig) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.expert_d_ff, m.n_experts
    dt = cfg.param_dtype
    return {
        "w_gate": L.param(gen, (e, d, f),
                          ("experts", "expert_in", "expert_ff"), dtype=dt),
        "w_up": L.param(gen, (e, d, f),
                        ("experts", "expert_in", "expert_ff"), dtype=dt),
        "w_down": L.param(gen, (e, f, d),
                          ("experts", "expert_ff", "expert_in"), dtype=dt),
    }


def init_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dtype = cfg.param_dtype
    return {
        "ln_attn": L.init_norm(gen, cfg.d_model, kind=cfg.norm, dtype=dtype),
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.resolved_head_dim,
                               qkv_bias=cfg.qkv_bias, dtype=dtype),
        "ln_mlp": L.init_norm(gen, cfg.d_model, kind=cfg.norm, dtype=dtype),
        "router": init_router(gen, cfg),
        "experts": init_experts(gen, cfg),
    }


def _route(router: dict, x: torch.Tensor, cfg: ArchConfig):
    """x:(B,C,D) -> (weights (B,C,k), indices (B,C,k), router_probs
    (B,C,E)); the top-k weights renormalised to sum to one."""
    logits = x.float() @ router["w"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return top_w, top_idx, probs


def capacity(cfg: ArchConfig, chunk: int) -> int:
    """Slots an expert has in a chunk of ``chunk`` tokens."""
    m = cfg.moe
    return max(int(m.capacity_factor * chunk * m.top_k / m.n_experts), 1)


def capacity_slots(onehot: torch.Tensor):
    """Each (token, k) assignment's slot in its expert's buffer: the count
    of earlier assignments to the same expert in the chunk.  onehot:
    (B,c,K,E) float32 -> (B,c,K,E), nonzero only where onehot is."""
    B, c, K, E = onehot.shape
    flat = onehot.reshape(B, c * K, E)
    return (torch.cumsum(flat, dim=1) - flat).reshape(B, c, K, E)


def moe_mlp(p: dict, x: torch.Tensor, cfg: ArchConfig, *,
            activation: str = "swiglu"):
    """Capacity-dispatch MoE ffn. x:(B,S,D) -> ((B,S,D), float32 aux
    load-balance loss)."""
    m = cfg.moe
    B, S, D = x.shape
    chunk = min(MOE_CHUNK, S)
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the MoE chunk "
                         f"{chunk}")
    E = m.n_experts
    cap = capacity(cfg, chunk)
    ex = p["experts"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        xi = x[:, c0:c0 + chunk]
        top_w, top_idx, probs = _route(p["router"], xi, cfg)    # (B,c,K)
        onehot = F.one_hot(top_idx, E).float()                  # (B,c,K,E)
        pos = capacity_slots(onehot)
        in_cap = (pos < cap).float()
        slot_idx = (pos * onehot).sum(-1)                       # (B,c,K)
        # one-hot over the slots; an index past the capacity gives zeros
        slot = (slot_idx[..., None] == torch.arange(
            cap, device=x.device, dtype=slot_idx.dtype)).float()  # (B,c,K,C)
        # a token's k experts differ, so each (token, expert) sum over k
        # holds at most one nonzero term
        dispatch = shd.einsum("bske,bskc->bsec", onehot * in_cap, slot)
        combine = dispatch * (top_w[..., None] * onehot).sum(2)[..., None]
        dispatch = lc(dispatch, ("batch", "seq", "experts_act", "capacity"))
        xin = shd.einsum("bsec,bsd->becd", dispatch.to(cfg.param_dtype),
                         xi)
        xin = lc(xin, ("batch", "experts_act", "capacity", "embed"))
        g = shd.einsum("becd,edf->becf", xin, ex["w_gate"].to(xin.dtype))
        u = shd.einsum("becd,edf->becf", xin, ex["w_up"].to(xin.dtype))
        h = lc(L._act(activation, g) * u,
               ("batch", "experts_act", "capacity", "tp"))
        out = shd.einsum("becf,efd->becd", h, ex["w_down"].to(xin.dtype))
        ys.append(shd.einsum("becd,bsec->bsd", out,
                             combine.to(xin.dtype)))
        # Switch-style load-balance loss: E * sum_e frac_tokens * frac_prob
        frac_tokens = onehot.mean((1, 2))                       # (B,E)
        frac_prob = probs.mean(1)                               # (B,E)
        aux = aux + E * (frac_tokens * frac_prob).sum(-1).mean()
    return torch.cat(ys, dim=1), aux / (S // chunk)


def apply_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, causal_skip: bool = False
                ) -> torch.Tensor:
    x, _, _ = attention_residual(p, x, positions, cfg,
                                 causal_skip=causal_skip)
    h = L.norm(p["ln_mlp"], x, kind=cfg.norm)
    y, _aux = moe_mlp(p, h, cfg, activation=cfg.activation)
    return lc(x + y, ("batch", "seq", "embed"))


def decode_block(p: dict, x: torch.Tensor, cache: dict, pos: int,
                 cfg: ArchConfig) -> torch.Tensor:
    """One-token decode: attention over the cache (written in place), then
    the top-k experts, by ``cfg.moe_decode``: ``dispatch`` runs every
    expert on a one-hot input and combines, ``gather`` indexes the top-k
    experts' weights per token."""
    x = decode_residual(p, x, cache, pos, cfg)
    h = L.norm(p["ln_mlp"], x, kind=cfg.norm)
    top_w, top_idx, _ = _route(p["router"], h, cfg)     # (B,1,K)
    ex = p["experts"]
    hv = h[:, 0].to(cfg.param_dtype)                    # (B,D)
    if cfg.moe_decode == "gather":
        idx = top_idx[:, 0]                             # (B,K)
        g = torch.einsum("bd,bkdf->bkf", hv, ex["w_gate"][idx].to(hv.dtype))
        u = torch.einsum("bd,bkdf->bkf", hv, ex["w_up"][idx].to(hv.dtype))
        act = L._act(cfg.activation, g) * u
        y = torch.einsum("bkf,bkfd->bkd", act, ex["w_down"][idx].to(hv.dtype))
        y = torch.einsum("bkd,bk->bd", y, top_w[:, 0].to(hv.dtype))
        return x + y[:, None]
    onehot = F.one_hot(top_idx[:, 0], cfg.moe.n_experts).float()  # (B,K,E)
    combine = (top_w[:, 0, :, None] * onehot).sum(1)    # (B,E)
    dispatch = lc((onehot.sum(1) > 0).to(cfg.param_dtype),
                  ("batch", "experts_act"))
    xin = lc(torch.einsum("be,bd->ebd", dispatch, hv),  # (E,B,D)
             ("experts_act", "batch", "embed"))
    g = torch.einsum("ebd,edf->ebf", xin, ex["w_gate"].to(hv.dtype))
    u = torch.einsum("ebd,edf->ebf", xin, ex["w_up"].to(hv.dtype))
    act = L._act(cfg.activation, g) * u
    out = torch.einsum("ebf,efd->ebd", act, ex["w_down"].to(hv.dtype))
    y = torch.einsum("ebd,be->bd", out, combine.to(hv.dtype))
    return x + y[:, None]
