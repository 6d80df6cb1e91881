"""Pixtral-style VLM backbone: a text decoder consuming stubbed patch
embeddings.

The vision tower is a stub, as in the reference (``repro/models/vlm.py``):
callers provide ``patch_embeds: (B, P, patch_embed_dim)``.  The backbone
owns the projector and lays the projected patches over the first ``P``
positions of the text embeddings (image first).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch import sharding as shd
from repro_torch.models import transformer as T


def init_vlm(gen: torch.Generator, cfg: ArchConfig) -> dict:
    p = T.init_lm(gen, cfg)
    p["projector"] = L.init_linear(gen, cfg.vlm.patch_embed_dim, cfg.d_model,
                                   dtype=cfg.param_dtype, axes=("fsdp", "tp"))
    return p


def project_patches(params: dict, patch_embeds: torch.Tensor, seq_len: int,
                    cfg: ArchConfig) -> torch.Tensor:
    """(B,P,pd) -> (B,S,D) extra embeddings, patches at positions [0, P)."""
    proj = L.linear(params["projector"], patch_embeds.to(cfg.param_dtype))
    P = proj.shape[1]
    if P > seq_len:
        raise ValueError(f"{P} patches do not fit {seq_len} positions")
    return shd.pad(proj, (0, 0, 0, seq_len - P))


def forward_vlm(params: dict, tokens: torch.Tensor,
                patch_embeds: torch.Tensor, cfg: ArchConfig, *,
                remat: str = "full", causal_skip: bool = False
                ) -> torch.Tensor:
    extra = project_patches(params, patch_embeds, tokens.shape[1], cfg)
    return T.forward_lm(params, tokens, cfg, remat=remat,
                        causal_skip=causal_skip, extra_embeds=extra)
