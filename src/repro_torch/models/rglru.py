"""RecurrentGemma / Griffin hybrid: RG-LRU recurrent blocks + local attention.

As in the reference (``repro/models/rglru.py``), the layer stack repeats
``cfg.hybrid.pattern`` (default rglru, rglru, attn).  A *superblock* is
one full pattern; the LM walks the superblocks, and the remainder layers
(38 = 12 x 3 + 2) are stacked separately by the LM
(``transformer._n_stack``).  The attention blocks are the dense decoder
blocks of ``transformer.py`` under a sliding window of
``cfg.hybrid.attn_window``.

RG-LRU recurrence (Griffin eq. 3-4, per-channel gates):
    r_t = sigmoid(w_a * x_t + b_a)
    i_t = sigmoid(w_x * x_t + b_x)
    a_t = exp(-c * softplus(lam) * r_t),     c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The forward pass scans it ``RG_CHUNK`` steps at a time with the SSM's
chunk scan (``ssm.chunked_scan``); decode writes the layer's cache in
place and returns the block's output.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.ssm import (_causal_conv, chunked_scan, conv_step,
                                    softplus)
from repro_torch.sharding import lc

BSE = ("batch", "seq", "embed")

RG_C = 8.0
RG_CHUNK = 128
CONV_WIDTH = 4


def _lru_width(cfg: ArchConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def _attn_cfg(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, sliding_window=cfg.hybrid.attn_window,
                               family="dense")


def init_rglru_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    d, w = cfg.d_model, _lru_width(cfg)
    dt = cfg.param_dtype
    return {
        "norm": L.init_norm(gen, d, kind=cfg.norm, dtype=dt),
        "in_main": L.init_linear(gen, d, w, dtype=dt, axes=("fsdp", "tp")),
        "in_gate": L.init_linear(gen, d, w, dtype=dt, axes=("fsdp", "tp")),
        "conv_w": L.param(gen, (CONV_WIDTH, w), ("conv", "tp"), "normal",
                          dtype=dt),
        "conv_b": L.param(gen, (w,), ("tp",), "zeros", dtype=dt),
        "w_a": L.param(gen, (w,), ("tp",), "uniform", 0.5),
        "b_a": L.param(gen, (w,), ("tp",), "zeros"),
        "w_x": L.param(gen, (w,), ("tp",), "uniform", 0.5),
        "b_x": L.param(gen, (w,), ("tp",), "zeros"),
        "lam": L.param(gen, (w,), ("tp",), "uniform", 1.0),
        "out": L.init_linear(gen, w, d, dtype=dt, axes=("tp", "fsdp")),
        "ln_mlp": L.init_norm(gen, d, kind=cfg.norm, dtype=dt),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                          activation=cfg.activation, dtype=dt),
    }


def _rglru_gates(p: dict, x: torch.Tensor):
    """x:(B,S,W) float32 -> (a, b) recurrence elements."""
    r = torch.sigmoid(p["w_a"][None, None] * x + p["b_a"][None, None])
    i = torch.sigmoid(p["w_x"][None, None] * x + p["b_x"][None, None])
    log_a = -RG_C * softplus(p["lam"])[None, None] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a.square(), min=1e-12)) * (i * x)
    return a, b


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """Linear recurrence over seq. a,b:(B,S,W); h0:(B,W) ->
    (h_seq (B,S,W), h_last (B,W))."""
    return chunked_scan(a, b, h0, RG_CHUNK)


def apply_rglru_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ArchConfig, *, causal_skip: bool = False
                      ) -> torch.Tensor:
    del positions, causal_skip
    h = L.norm(p["norm"], x, kind=cfg.norm)
    main = L.linear(p["in_main"], h)
    gate = L._act("gelu", L.linear(p["in_gate"], h))
    main = lc(main, ("batch", "seq", "inner_act"))
    main = _causal_conv(main, p["conv_w"].to(main.dtype),
                        p["conv_b"].to(main.dtype))
    a, b = _rglru_gates(p, main.float())
    B, _, W = main.shape
    hseq, _ = rglru_scan(a, b, torch.zeros((B, W), dtype=torch.float32,
                                           device=x.device))
    y = lc(hseq.to(x.dtype) * gate, ("batch", "seq", "inner_act"))
    x = lc(x + L.linear(p["out"], y), BSE)
    return lc(T.mlp_residual(p, x, cfg), BSE)


def init_rglru_cache(cfg: ArchConfig, batch: int, device) -> dict:
    w = _lru_width(cfg)
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, w),
                            dtype=cfg.param_dtype, device=device),
    }


def decode_rglru_block(p: dict, x: torch.Tensor, cache: dict, pos: int,
                       cfg: ArchConfig) -> torch.Tensor:
    """x:(B,1,D) one-step recurrence; writes the layer's cache in place."""
    del pos
    h = L.norm(p["norm"], x, kind=cfg.norm)
    main = L.linear(p["in_main"], h)                       # (B,1,W)
    gate = L._act("gelu", L.linear(p["in_gate"], h))
    mc = conv_step(cache, main, p["conv_w"], p["conv_b"])
    a, b = _rglru_gates(p, mc[:, None].float())
    h_new = a[:, 0] * cache["h"] + b[:, 0]                 # (B,W)
    cache["h"].copy_(h_new)
    y = h_new[:, None].to(x.dtype) * gate
    x = x + L.linear(p["out"], y)
    return T.mlp_residual(p, x, cfg)


# ------------------------------------------------------- kind dispatch layer

def init_block_kind(gen: torch.Generator, cfg: ArchConfig, kind: str):
    if kind == "rglru":
        return init_rglru_block(gen, cfg)
    return T.init_block(gen, _attn_cfg(cfg))


def apply_block_kind(p: dict, x: torch.Tensor, positions: torch.Tensor,
                     cfg: ArchConfig, kind: str, *,
                     causal_skip: bool = False) -> torch.Tensor:
    if kind == "rglru":
        return apply_rglru_block(p, x, positions, cfg)
    return T.apply_block(p, x, positions, _attn_cfg(cfg),
                         causal_skip=causal_skip)


def init_block_kind_cache(cfg: ArchConfig, batch: int, cache_len: int,
                          kind: str, device) -> dict:
    if kind == "rglru":
        return init_rglru_cache(cfg, batch, device)
    return T.init_block_cache(_attn_cfg(cfg), batch, cache_len, device)


def decode_block_kind(p: dict, x: torch.Tensor, cache: dict, pos: int,
                      cfg: ArchConfig, kind: str) -> torch.Tensor:
    if kind == "rglru":
        return decode_rglru_block(p, x, cache, pos, cfg)
    return T.decode_block(p, x, cache, pos, _attn_cfg(cfg))


# ------------------------------------------------------------- superblocks

def init_superblock(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {f"b{i}": init_block_kind(gen, cfg, kind)
            for i, kind in enumerate(cfg.hybrid.pattern)}


def apply_superblock(p: dict, x: torch.Tensor, positions: torch.Tensor,
                     cfg: ArchConfig, *, causal_skip: bool = False
                     ) -> torch.Tensor:
    for i, kind in enumerate(cfg.hybrid.pattern):
        x = apply_block_kind(p[f"b{i}"], x, positions, cfg, kind,
                             causal_skip=causal_skip)
    return x


def init_superblock_cache(cfg: ArchConfig, batch: int, cache_len: int,
                          device) -> dict:
    return {f"b{i}": init_block_kind_cache(cfg, batch, cache_len, kind,
                                           device)
            for i, kind in enumerate(cfg.hybrid.pattern)}


def decode_superblock(p: dict, x: torch.Tensor, cache: dict, pos: int,
                      cfg: ArchConfig) -> torch.Tensor:
    for i, kind in enumerate(cfg.hybrid.pattern):
        x = decode_block_kind(p[f"b{i}"], x, cache[f"b{i}"], pos, cfg, kind)
    return x
