"""Architecture config, without JAX.

The fields the paper's CNN configs set, under the reference's names
(``repro/configs/base.py``); the CNN family re-purposes ``d_model`` as the
base conv width, ``d_ff`` as the dense hidden width and ``vocab_size`` as
the class count.  The LM families' fields arrive with the pod slice.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # cnn (the LM families: pod slice)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    dtype: str = "bfloat16"
    source: str = ""               # citation for the config numbers

    @property
    def param_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)
