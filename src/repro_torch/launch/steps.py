"""Step functions and input specs for the server.

  prefill_step(params, batch)        -> logits              (prefill)
  serve_step(params, cache, batch)   -> (logits, cache)     (1-token decode)

The reference's training step, its sharding helpers and its per-shape
rules (``repro/launch/steps.py``) arrive with the pod trainer and the
multi-card slice (ROADMAP queue 1, 'Pod path' (b) and (c)).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models.registry import Model


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Stand-ins for a step's batch on the ``meta`` device (shapes and
    dtypes, no storage)."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    specs = {"tokens": torch.empty((B, S), dtype=torch.int32,
                                   device="meta")}
    if cfg.family == "vlm" and shape.kind != "decode":
        v = cfg.vlm
        specs["patch_embeds"] = torch.empty(
            (B, v.n_patches, v.patch_embed_dim), dtype=cfg.param_dtype,
            device="meta")
    if cfg.family == "encdec" and shape.kind != "decode":
        e = cfg.encdec
        specs["frames"] = torch.empty((B, e.n_frames, cfg.d_model),
                                      dtype=cfg.param_dtype, device="meta")
    return specs


def make_prefill_step(model: Model, *, causal_skip: bool = False):
    def prefill_step(params, batch):
        return model.forward(params, batch, causal_skip=causal_skip)

    return prefill_step


def make_serve_step(model: Model):
    def serve_step(params, cache, batch):
        return model.decode(params, cache, batch)

    return serve_step
