"""Model API over every architecture family: cnn, and the LMs (dense,
moe, vlm, ssm, hybrid, encdec, and the port's mla_moe).

``batch`` dicts carry the model inputs:
  - the LM families: ``tokens (B,S)`` (int32 or int64)
  - vlm: + ``patch_embeds (B,P,pd)``  (stubbed vision tower output)
  - encdec: + ``frames (B,F,D)``      (stubbed audio frontend output)
  - cnn: ``images (B,H,W,C)`` + ``labels (B,)``
Decode batches carry ``tokens (B,1)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import sharding as shd
from repro_torch.configs.base import ArchConfig
from repro_torch.models import cnn as cnn_mod
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import layers as L
from repro_torch.models import mla_moe as mla_moe_mod
from repro_torch.models import transformer as T
from repro_torch.models import vlm as vlm_mod
from repro_torch.utils.pytree import tree_map


class Model(NamedTuple):
    cfg: ArchConfig
    # (torch.Generator, device) -> params; the LM families default the
    # device to the generator's
    init: Callable
    forward: Callable               # (params, batch, **kw) -> logits
    # (batch_size, cache_len, device) -> cache
    init_cache: Optional[Callable] = None
    # (params, cache, batch) -> (logits, cache), the cache written in place
    decode: Optional[Callable] = None

    def abstract_params(self):
        """The parameters as ``meta`` tensors (shapes and dtypes)."""
        return L.abstract_params(self.init, None)

    def logical_axes(self):
        """Each parameter's ``layers.LogicalAxes``."""
        return L.logical_axes(self.init, None)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family == "cnn":
        def init(gen: torch.Generator, device="cpu"):
            params = cnn_mod.init_cnn(gen, cfg)
            if device is None:
                return params
            return tree_map(lambda t: t.to(device), params)

        def forward(params, batch, **kw):
            return cnn_mod.apply_cnn(params, batch["images"])

        return Model(cfg, init, forward)

    init_fn = {"vlm": vlm_mod.init_vlm,
               "encdec": encdec_mod.init_encdec,
               "mla_moe": mla_moe_mod.init_lm}.get(cfg.family, T.init_lm)

    def init(gen: torch.Generator, device=None):
        """Parameters drawn on ``gen``'s device and left there, or moved
        to ``device`` where the caller names another."""
        params = init_fn(gen, cfg)
        if device is None:
            return params
        return tree_map(lambda t: t.to(device), params)

    if cfg.family == "encdec":
        def forward(params, batch, **kw):
            return encdec_mod.forward_encdec(params, batch["frames"],
                                             batch["tokens"], cfg,
                                             remat=kw.get("remat", "full"))

        def init_cache(batch_size, cache_len, device):
            return encdec_mod.init_encdec_cache(cfg, batch_size, cache_len,
                                                device)

        def decode(params, cache, batch):
            return encdec_mod.decode_encdec(params, cache, batch["tokens"],
                                            cfg)

        return Model(cfg, init, forward, init_cache, decode)

    if cfg.family == "mla_moe":
        def forward(params, batch, **kw):
            return mla_moe_mod.forward(params, batch["tokens"], cfg, **kw)

        return Model(cfg, init, forward, mla_moe_mod.init_cache,
                     mla_moe_mod.decode)

    if cfg.family == "vlm":
        def forward(params, batch, **kw):
            return vlm_mod.forward_vlm(params, batch["tokens"],
                                       batch["patch_embeds"], cfg, **kw)
    else:   # dense / moe / ssm / hybrid
        def forward(params, batch, **kw):
            return T.forward_lm(params, batch["tokens"], cfg, **kw)

    def init_cache(batch_size, cache_len, device):
        return T.init_lm_cache(cfg, batch_size, cache_len, device)

    def decode(params, cache, batch):
        return T.decode_lm(params, cache, batch["tokens"], cfg)

    return Model(cfg, init, forward, init_cache, decode)


def lm_loss(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy. logits:(B,S,V), tokens:(B,S)."""
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    targets = tokens[:, 1:].long()
    return -logp.gather(-1, targets[..., None]).mean()


def cls_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Classification cross entropy. logits:(B,C), labels:(B,)."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()


def loss_fn(model: Model, params, batch, **kw) -> torch.Tensor:
    """The loss a step differentiates: cross entropy, and where the family
    has one (mla_moe's balance loss) its auxiliary term added."""
    if model.cfg.family == "mla_moe":
        logits, aux = model.forward(params, batch, aux=True, **kw)
        tokens = batch["tokens"]
        if shd.is_dtensor(tokens):
            # the family's logits are whole (``mla_moe.forward``)
            tokens = tokens.full_tensor()
        return lm_loss(logits, tokens) + aux
    logits = model.forward(params, batch, **kw)
    if model.cfg.family == "cnn":
        return cls_loss(logits, batch["labels"])
    return lm_loss(logits, batch["tokens"])
