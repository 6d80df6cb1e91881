"""Decoder-only LM machinery: stacked layers, dense blocks, prefill/decode.

As in the reference (``repro/models/transformer.py``), every per-layer
leaf is stacked along a leading ``layers`` axis under ``params["blocks"]``
and the family modules provide (init_block, apply_block,
init_block_cache, decode_block): dense and vlm here, moe in ``moe.py``,
ssm in ``ssm.py``, and hybrid in ``rglru.py``, whose stack entries are
superblocks (one repeat of the block pattern) with the remainder layers
stacked under ``params["tail"]`` (recurrentgemma: 38 = 12 x 3 + 2).  The
port walks the stacks with a Python loop over the layer views where the
reference scans (:func:`scan_blocks`, which also applies the reference's
``remat`` policy to each block).

The decode cache is ``{"blocks": <the family's cache, stacked>, "pos":
int}`` (+ ``"tail"`` for hybrid), the reference's layout with ``pos`` a
host integer; the attention families' is ``{"k", "v": (L,B,T,Hkv,hd),
"k_pos": (L,T) int32}``.  Decode writes it in place (the reference
returns a new one): :func:`decode_lm` returns the cache it was given,
advanced by a token.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.attention import (attention_residual,
                                          decode_residual, init_attention)
from repro_torch.sharding import lc
from repro_torch.utils.pytree import PyTree, tree_leaves, tree_map

BSE = ("batch", "seq", "embed")

# ------------------------------------------------------------- layer stacking

def init_stack(gen: torch.Generator, n: int,
               init_fn: Callable[[torch.Generator], PyTree]) -> PyTree:
    """Stack ``n`` independently initialized blocks along a leading
    ``layers`` axis, one layer at a time (each layer's fan-in is its own,
    and only one layer's float32 draws are alive at once).  ``n`` may be
    0 (a hybrid stack shorter than one pattern).  In the axes mode each
    leaf's axes gain a leading ``"layers"``, in the shape mode its
    ``meta`` tensor a leading ``n`` (``layers.logical_axes``)."""
    if L._MODE.axes_mode:
        return tree_map(lambda ax: ax.prepend("layers"), init_fn(gen))
    if L._MODE.shape_mode:
        return tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                        init_fn(gen))
    first = init_fn(gen)
    stacked = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    if n == 0:
        return stacked
    tree_map(lambda s, t: s[0].copy_(t), stacked, first)
    del first
    for i in range(1, n):
        tree_map(lambda s, t, i=i: s[i].copy_(t), stacked, init_fn(gen))
    return stacked


def layer(stacked: PyTree, i: int) -> PyTree:
    """Layer ``i``'s views of a stacked tree."""
    return tree_map(lambda t: t[i], stacked)


REMAT = ("full", "dots", "none")


def _save_dots():
    """Selective checkpointing that keeps the matrix products' outputs and
    recomputes the rest, the reference's ``checkpoint_dots`` policy."""
    aten = torch.ops.aten
    return create_selective_checkpoint_contexts(
        [aten.mm.default, aten.bmm.default, aten.addmm.default])


def scan_blocks(apply_fn: Callable, stacked: PyTree, x: torch.Tensor, *,
                remat: str = "full") -> torch.Tensor:
    """``x`` through ``apply_fn(layer_i, x)`` for each layer of the stacked
    tree in order, the reference's ``scan_blocks`` as a Python loop.
    ``remat``: ``"full"`` recomputes each block's activations in the
    backward pass (``torch.utils.checkpoint``), ``"dots"`` keeps its
    matrix products' outputs and recomputes the rest, ``"none"`` keeps
    everything autograd saves."""
    if remat not in REMAT:
        raise ValueError(remat)
    # the layers as one unbind of each leaf: its backward stacks the
    # layers' gradients once, where a select per layer would write a
    # zero tensor of the whole stack for each layer and add them up
    per_layer = tree_map(lambda t: t.unbind(0), stacked)
    for i in range(len(tree_leaves(per_layer)[0])):
        p = tree_map(lambda u: u[i], per_layer)
        if remat == "none":
            x = apply_fn(p, x)
        else:
            x = checkpoint(apply_fn, p, x, use_reentrant=False,
                           **({"context_fn": _save_dots}
                              if remat == "dots" else {}))
    return x


# ------------------------------------------------------------- dense blocks

def init_block(gen: torch.Generator, cfg: ArchConfig) -> dict:
    dtype = cfg.param_dtype
    return {
        "ln_attn": L.init_norm(gen, cfg.d_model, kind=cfg.norm, dtype=dtype),
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.resolved_head_dim,
                               qkv_bias=cfg.qkv_bias, dtype=dtype),
        "ln_mlp": L.init_norm(gen, cfg.d_model, kind=cfg.norm, dtype=dtype),
        "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                          activation=cfg.activation, dtype=dtype),
    }


def mlp_residual(p: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """``x + mlp(norm(x))`` of a block ``p`` (its ``ln_mlp`` and ``mlp``)."""
    h = L.norm(p["ln_mlp"], x, kind=cfg.norm)
    return x + L.mlp(p["mlp"], h, activation=cfg.activation)


def apply_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                cfg: ArchConfig, *, causal_skip: bool = False
                ) -> torch.Tensor:
    x, _, _ = attention_residual(p, x, positions, cfg,
                                 causal_skip=causal_skip)
    return lc(mlp_residual(p, x, cfg), BSE)


def cache_len_for(cfg: ArchConfig, cache_len: int) -> int:
    """Cache slots T: the window under a sliding window, else cache_len."""
    return cache_len if cfg.sliding_window is None \
        else min(cache_len, cfg.sliding_window)


def init_block_cache(cfg: ArchConfig, batch: int, cache_len: int,
                     device) -> dict:
    T = cache_len_for(cfg, cache_len)
    shape = (batch, T, cfg.n_kv_heads, cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.param_dtype, device=device),
        "k_pos": torch.full((T,), -1, dtype=torch.int32, device=device),
    }


def decode_block(p: dict, x: torch.Tensor, cache: dict, pos: int,
                 cfg: ArchConfig) -> torch.Tensor:
    """One-token decode. x:(B,1,D); writes the layer's cache in place."""
    return mlp_residual(p, decode_residual(p, x, cache, pos, cfg), cfg)


def prefill_cache(k: torch.Tensor, v: torch.Tensor, positions: torch.Tensor,
                  cfg: ArchConfig, cache_len: int) -> dict:
    """A layer's decode cache from its prompt keys and values, in
    :func:`init_block_cache`'s layout.  When a sliding window is shorter
    than the prompt, the tail is kept, ring-aligned so that decode's
    ``pos % T`` slots continue it."""
    S = k.shape[1]
    T = cache_len_for(cfg, cache_len)
    pos = positions[0].to(torch.int32)
    if T >= S:
        pad = (0, 0, 0, 0, 0, T - S)
        return {"k": torch.nn.functional.pad(k, pad),
                "v": torch.nn.functional.pad(v, pad),
                "k_pos": torch.cat([pos, pos.new_full((T - S,), -1)])}
    start, roll = S - T, S % T
    return {"k": torch.roll(k[:, start:], roll, dims=1),
            "v": torch.roll(v[:, start:], roll, dims=1),
            "k_pos": torch.roll(pos[start:], roll)}


def prefill_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ArchConfig, cache_len: int, *,
                  causal_skip: bool = False):
    """apply_block that also emits the layer's KV cache (batched prefill)."""
    x, k, v = attention_residual(p, x, positions, cfg,
                                 causal_skip=causal_skip)
    return lc(mlp_residual(p, x, cfg), BSE), prefill_cache(
        k, v, positions, cfg, cache_len)


def _moe_prefill_block(p: dict, x: torch.Tensor, positions: torch.Tensor,
                       cfg: ArchConfig, cache_len: int, causal_skip: bool):
    from repro_torch.models import moe
    x, k, v = attention_residual(p, x, positions, cfg,
                                 causal_skip=causal_skip)
    h = L.norm(p["ln_mlp"], x, kind=cfg.norm)
    y, _aux = moe.moe_mlp(p, h, cfg, activation=cfg.activation)
    return lc(x + y, BSE), prefill_cache(k, v, positions, cfg, cache_len)


# ----------------------------------------------------------------- LM level

def _family_fns(cfg: ArchConfig):
    """(init_block, apply_block, init_block_cache, decode_block) per family."""
    if cfg.family in ("dense", "vlm"):
        return init_block, apply_block, init_block_cache, decode_block
    if cfg.family == "moe":
        from repro_torch.models import moe
        return (moe.init_block, moe.apply_block, init_block_cache,
                moe.decode_block)
    if cfg.family == "ssm":
        from repro_torch.models import ssm
        return (ssm.init_block, ssm.apply_block, ssm.init_block_cache,
                ssm.decode_block)
    if cfg.family == "hybrid":
        from repro_torch.models import rglru
        return (rglru.init_superblock, rglru.apply_superblock,
                rglru.init_superblock_cache, rglru.decode_superblock)
    raise ValueError(cfg.family)


def _n_stack(cfg: ArchConfig) -> tuple[int, int]:
    """(number of stack entries, remainder layers)."""
    if cfg.family == "hybrid":
        plen = len(cfg.hybrid.pattern)
        return cfg.n_layers // plen, cfg.n_layers % plen
    return cfg.n_layers, 0


def _tail_kind(cfg: ArchConfig) -> str:
    """The remainder layers' block kind: the pattern's first."""
    return cfg.hybrid.pattern[0]


def seq_positions(B: int, S: int, device) -> torch.Tensor:
    """int32 positions 0..S-1 of each of B sequences, (B, S)."""
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def _embed_input(params: PyTree, tokens: torch.Tensor, cfg: ArchConfig,
                 extra_embeds) -> torch.Tensor:
    x = L.embed(params["embed"], tokens).to(cfg.param_dtype)
    if extra_embeds is not None:
        x = x + extra_embeds.to(cfg.param_dtype)
    return x


def _logits(params: PyTree, x: torch.Tensor, cfg: ArchConfig
            ) -> torch.Tensor:
    x = L.norm(params["ln_f"], x, kind=cfg.norm)
    if cfg.tie_embeddings:
        return L.unembed(params["embed"], x)
    return L.head_logits(params["unembed"], x, bf16=cfg.logits_bf16)


def init_lm(gen: torch.Generator, cfg: ArchConfig) -> PyTree:
    fns = _family_fns(cfg)
    n_stack, n_rem = _n_stack(cfg)
    p = {
        "embed": L.init_embedding(gen, cfg.vocab_size, cfg.d_model,
                                  dtype=cfg.param_dtype),
        "blocks": init_stack(gen, n_stack, lambda g: fns[0](g, cfg)),
        "ln_f": L.init_norm(gen, cfg.d_model, kind=cfg.norm,
                            dtype=cfg.param_dtype),
    }
    if n_rem:
        from repro_torch.models import rglru
        p["tail"] = init_stack(gen, n_rem, lambda g: rglru.init_block_kind(
            g, cfg, _tail_kind(cfg)))
    if not cfg.tie_embeddings:
        p["unembed"] = L.init_linear(gen, cfg.d_model, cfg.vocab_size,
                                     dtype=cfg.param_dtype,
                                     axes=("fsdp", "tp"))
    return p


def forward_lm(params: PyTree, tokens: torch.Tensor, cfg: ArchConfig, *,
               remat: str = "full", causal_skip: bool = False,
               extra_embeds=None) -> torch.Tensor:
    """tokens:(B,S) -> float32 logits (B,S,V). extra_embeds: optional
    (B,S,D) added input embeddings (the VLM's projected patches).
    ``remat`` (:func:`scan_blocks`) covers the block stack and the hybrid
    ``tail``; a caller that takes no gradient passes ``"none"``."""
    B, S = tokens.shape
    x = lc(_embed_input(params, tokens, cfg, extra_embeds), BSE)
    positions = seq_positions(B, S, x.device)
    apply = _family_fns(cfg)[1]
    x = scan_blocks(lambda p, x: apply(p, x, positions, cfg,
                                       causal_skip=causal_skip),
                    params["blocks"], x, remat=remat)
    if "tail" in params:
        from repro_torch.models import rglru
        x = scan_blocks(lambda p, x: rglru.apply_block_kind(
            p, x, positions, cfg, _tail_kind(cfg), causal_skip=causal_skip),
            params["tail"], x, remat=remat)
    return lc(_logits(params, x, cfg), ("batch", "seq", "vocab_act"))


def prefill_lm(params: PyTree, tokens: torch.Tensor, cfg: ArchConfig,
               cache_len: int, *, causal_skip: bool = False,
               extra_embeds=None):
    """Batched prefill: one forward pass -> (logits, ready decode cache).
    The attention families only (dense, vlm, moe); the recurrent ones
    prefill through the decode loop (``launch/serve.prefill_into_cache``),
    as in the reference, whose ``prefill_lm`` asserts the same."""
    if cfg.family not in ("dense", "vlm", "moe"):
        raise ValueError(
            f"prefill_lm: family {cfg.family!r} has no batched prefill; "
            f"step its decode path (serve.prefill_into_cache)")
    if cache_len < 1:
        raise ValueError(f"cache_len {cache_len} < 1")
    B, S = tokens.shape
    x = _embed_input(params, tokens, cfg, extra_embeds)
    positions = seq_positions(B, S, x.device)
    blocks = params["blocks"]
    caches = []
    for i in range(cfg.n_layers):
        p = layer(blocks, i)
        if cfg.family == "moe":
            x, c = _moe_prefill_block(p, x, positions, cfg, cache_len,
                                      causal_skip)
        else:
            x, c = prefill_block(p, x, positions, cfg, cache_len,
                                 causal_skip=causal_skip)
        caches.append(c)
    stacked = {k: torch.stack([c[k] for c in caches]) for k in caches[0]}
    return _logits(params, x, cfg), {"blocks": stacked, "pos": S}


def repeat_stack(n: int, one: PyTree) -> PyTree:
    """``n`` copies of a tree stacked along a new leading axis."""
    return tree_map(lambda v: v.expand((n,) + tuple(v.shape)).clone(), one)


def init_lm_cache(cfg: ArchConfig, batch: int, cache_len: int,
                  device) -> dict:
    n_stack, n_rem = _n_stack(cfg)
    one = _family_fns(cfg)[2](cfg, batch, cache_len, device)
    out = {"blocks": repeat_stack(n_stack, one), "pos": 0}
    if n_rem:
        from repro_torch.models import rglru
        out["tail"] = repeat_stack(n_rem, rglru.init_block_kind_cache(
            cfg, batch, cache_len, _tail_kind(cfg), device))
    return out


def decode_lm(params: PyTree, cache: dict, tokens: torch.Tensor,
              cfg: ArchConfig):
    """One decode step. tokens:(B,1) -> (logits (B,1,V), cache), the
    cache written in place and its ``pos`` advanced."""
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens).to(cfg.param_dtype)
    decode = _family_fns(cfg)[3]
    n_stack, n_rem = _n_stack(cfg)
    for i in range(n_stack):
        x = decode(layer(params["blocks"], i), x,
                   layer(cache["blocks"], i), pos, cfg)
    if n_rem:
        from repro_torch.models import rglru
        for i in range(n_rem):
            x = rglru.decode_block_kind(layer(params["tail"], i), x,
                                        layer(cache["tail"], i), pos, cfg,
                                        _tail_kind(cfg))
    cache["pos"] = pos + 1
    return _logits(params, x, cfg), cache
