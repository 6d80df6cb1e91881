"""Model API for the cnn family (the LM families arrive with the pod path).

``batch`` dicts carry ``images (B,H,W,C)`` and ``labels (B,)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.utils.pytree import tree_map


class Model(NamedTuple):
    cfg: ArchConfig
    init: Callable      # (torch.Generator, device) -> params
    forward: Callable   # (params, batch) -> logits


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family != "cnn":
        raise NotImplementedError(
            f"family {cfg.family!r}: the LM families arrive with the pod "
            f"path (ROADMAP queue 1)")

    def init(gen: torch.Generator, device="cpu"):
        return tree_map(lambda t: t.to(device), cnn_mod.init_cnn(gen, cfg))

    def forward(params, batch):
        return cnn_mod.apply_cnn(params, batch["images"])

    return Model(cfg, init, forward)


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Classification cross entropy. logits:(B,C), labels:(B,)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def loss_fn(model: Model, params, batch) -> torch.Tensor:
    return cls_loss(model.forward(params, batch), batch["labels"])
