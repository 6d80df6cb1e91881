"""Encoder-decoder backbone (the SeamlessM4T v2 large language backbone).

As in the reference (``repro/models/encdec.py``), the modality frontend
(mel-spectrogram and conv feature extractor) is a stub: callers provide
precomputed frame embeddings ``frames: (B, n_frames, d_model)``.  The
backbone is a bidirectional encoder over the frames and a causal decoder
with cross-attention, both stacked along a leading ``layers`` axis
(``params["enc"]``, ``params["dec"]``) and walked by a Python loop.  The
self-attention halves are the decoder LM's (``attention_residual``,
``decode_residual``), which read ``cfg.sliding_window``: None in every
encdec config, as the reference's encdec blocks assume.

The decode cache is ``{"dec": {"self": {"k", "v": (L,B,T,Hkv,hd),
"k_pos": (L,T)}, "cross": {"k", "v": (L,B,F,Hkv,hd)}}, "pos": int}``.
:func:`init_encdec_cache` leaves the cross-attention K/V zero;
:func:`prefill_encdec_cache` runs the encoder over the frames and fills
them.  Decode writes the self-attention cache in place at slot
``min(pos, T - 1)`` and returns the cache it was given.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.attention import (attend, attention_decode,
                                          attention_residual,
                                          decode_residual, init_attention)
from repro_torch import sharding as shd
from repro_torch.sharding import lc
from repro_torch.utils.pytree import PyTree

BSE = ("batch", "seq", "embed")


def _init_attn(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return init_attention(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                          cfg.resolved_head_dim, qkv_bias=cfg.qkv_bias,
                          dtype=cfg.param_dtype)


def _init_norm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return L.init_norm(gen, cfg.d_model, kind=cfg.norm,
                       dtype=cfg.param_dtype)


def _init_mlp(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return L.init_mlp(gen, cfg.d_model, cfg.d_ff, activation=cfg.activation,
                      dtype=cfg.param_dtype)


def init_enc_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"ln_attn": _init_norm(gen, cfg), "attn": _init_attn(gen, cfg),
            "ln_mlp": _init_norm(gen, cfg), "mlp": _init_mlp(gen, cfg)}


def apply_enc_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    cfg: ArchConfig) -> torch.Tensor:
    x, _, _ = attention_residual(p, x, positions, cfg, causal=False)
    return lc(T.mlp_residual(p, x, cfg), BSE)


def init_dec_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    return {"ln_self": _init_norm(gen, cfg),
            "self_attn": _init_attn(gen, cfg),
            "ln_cross": _init_norm(gen, cfg),
            "cross_attn": _init_attn(gen, cfg),
            "ln_mlp": _init_norm(gen, cfg), "mlp": _init_mlp(gen, cfg)}


def _cross_kv(p: dict, memory: torch.Tensor, cfg: ArchConfig):
    """Project encoder memory to K/V. memory:(B,F,D)."""
    hd = cfg.resolved_head_dim
    k = shd.split_last(L.linear(p["wk"], memory), (cfg.n_kv_heads, hd))
    v = shd.split_last(L.linear(p["wv"], memory), (cfg.n_kv_heads, hd))
    return k, v


def _self_half(p: dict) -> dict:
    """A decoder block's self-attention under the names the decoder LM's
    attention half reads (``ln_attn``, ``attn``)."""
    return {"ln_attn": p["ln_self"], "attn": p["self_attn"]}


def _cross_q(p: dict, x: torch.Tensor, cfg: ArchConfig):
    """The cross-attention's normed queries (no RoPE). x:(B,S,D)."""
    h = L.norm(p["ln_cross"], x, kind=cfg.norm)
    return shd.split_last(L.linear(p["cross_attn"]["wq"], h),
                          (cfg.n_heads, cfg.resolved_head_dim))


def apply_dec_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                    memory: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    B, S = x.shape[:2]
    x, _, _ = attention_residual(_self_half(p), x, positions, cfg)
    # cross attention (no rope on the memory side)
    kc, vc = _cross_kv(p["cross_attn"], memory, cfg)
    fpos = torch.arange(memory.shape[1], dtype=torch.int32,
                        device=x.device)
    o = attend(_cross_q(p, x, cfg), kc, vc, positions[0], fpos,
               causal=False)
    x = lc(x + L.linear(p["cross_attn"]["wo"], o.reshape(B, S, -1)), BSE)
    return lc(T.mlp_residual(p, x, cfg), BSE)


def init_encdec(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    e = cfg.encdec
    dt = cfg.param_dtype
    return {
        "frontend_proj": L.init_linear(gen, cfg.d_model, cfg.d_model,
                                       dtype=dt, axes=("fsdp", "tp")),
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  dtype=dt),
        "enc": T.init_stack(gen, e.n_enc_layers,
                            lambda g: init_enc_block(g, cfg)),
        "ln_enc": _init_norm(gen, cfg),
        "dec": T.init_stack(gen, e.n_dec_layers,
                            lambda g: init_dec_block(g, cfg)),
        "ln_dec": _init_norm(gen, cfg),
        "unembed": L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                 dtype=dt, axes=("fsdp", "tp")),
    }


def encode(params: PyTree, frames: torch.Tensor, cfg: ArchConfig, *,
           remat: str = "full") -> torch.Tensor:
    """frames:(B,F,D) -> memory (B,F,D)."""
    B, F, _ = frames.shape
    x = L.linear(params["frontend_proj"], frames.to(cfg.param_dtype))
    # the frames carry the frontend's positional information; RoPE too
    pos = T.seq_positions(B, F, x.device)
    x = T.scan_blocks(lambda p, x: apply_enc_block(p, x, pos, cfg),
                      params["enc"], x, remat=remat)
    return L.norm(params["ln_enc"], x, kind=cfg.norm)


def _head(params: PyTree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = L.norm(params["ln_dec"], x, kind=cfg.norm)
    return L.head_logits(params["unembed"], x, bf16=cfg.logits_bf16)


def forward_encdec(params: PyTree, frames: torch.Tensor,
                   tokens: torch.Tensor, cfg: ArchConfig, *,
                   remat: str = "full") -> torch.Tensor:
    """(frames (B,F,D), tokens (B,S)) -> float32 logits (B,S,V)."""
    memory = encode(params, frames, cfg, remat=remat)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens).to(cfg.param_dtype)
    pos = T.seq_positions(B, S, x.device)
    x = T.scan_blocks(lambda p, x: apply_dec_block(p, x, pos, memory, cfg),
                      params["dec"], x, remat=remat)
    return _head(params, x, cfg)


def init_encdec_cache(cfg: ArchConfig, batch: int, cache_len: int,
                      device) -> dict:
    """Decoder self-attention cache + cross-attention K/V (zero)."""
    e = cfg.encdec
    hd = cfg.resolved_head_dim
    dt = cfg.param_dtype

    def zeros(n):
        return torch.zeros((batch, n, cfg.n_kv_heads, hd), dtype=dt,
                           device=device)

    per_layer = {
        "self": {"k": zeros(cache_len), "v": zeros(cache_len),
                 "k_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                     device=device)},
        "cross": {"k": zeros(e.n_frames), "v": zeros(e.n_frames)},
    }
    return {"dec": T.repeat_stack(e.n_dec_layers, per_layer), "pos": 0}


def prefill_encdec_cache(params: PyTree, frames: torch.Tensor,
                         cfg: ArchConfig, batch: int, cache_len: int
                         ) -> dict:
    """Run the encoder and fill the cross-attention K/V of every layer."""
    memory = encode(params, frames, cfg, remat="none")
    cache = init_encdec_cache(cfg, batch, cache_len, memory.device)
    kv = [_cross_kv(T.layer(params["dec"], i)["cross_attn"], memory, cfg)
          for i in range(cfg.encdec.n_dec_layers)]
    cache["dec"]["cross"] = {"k": torch.stack([k for k, _ in kv]),
                             "v": torch.stack([v for _, v in kv])}
    return cache


def decode_encdec(params: PyTree, cache: dict, tokens: torch.Tensor,
                  cfg: ArchConfig):
    """One decode step against the cached encoder memory. tokens:(B,1)
    -> (logits (B,1,V), cache), the cache written in place and its
    ``pos`` advanced."""
    B = tokens.shape[0]
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens).to(cfg.param_dtype)
    for i in range(cfg.encdec.n_dec_layers):
        p = T.layer(params["dec"], i)
        c = T.layer(cache["dec"], i)
        x = decode_residual(_self_half(p), x, c["self"], pos, cfg)
        ck, cv = c["cross"]["k"], c["cross"]["v"]
        F = ck.shape[1]
        o = attention_decode(
            _cross_q(p, x, cfg), ck, cv,
            torch.full((1,), F, dtype=torch.int32, device=x.device),
            torch.arange(F, dtype=torch.int32, device=x.device))
        x = x + L.linear(p["cross_attn"]["wo"], o.reshape(B, 1, -1))
        x = T.mlp_residual(p, x, cfg)
    cache["pos"] = pos + 1
    return _head(params, x, cfg), cache
