"""Config registry: ``--arch <id>`` resolution.

The assigned architectures (public-literature pool) and the paper's own
models, as in the reference's registry.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (DECODE_32K, INPUT_SHAPES, LONG_500K,
                                      PREFILL_32K, TRAIN_4K, ArchConfig,
                                      InputShape)

# arch id -> module name
_ARCH_MODULES = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "mistral-large-123b": "mistral_large_123b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "qwen2-7b": "qwen2_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama3-405b": "llama3_405b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "pixtral-12b": "pixtral_12b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    # paper's own experiment models
    "fmnist-cnn": "fmnist_cnn",
    "vgg9-cifar": "vgg9_cifar",
}

ASSIGNED_ARCHS = tuple(k for k in _ARCH_MODULES
                       if k not in ("fmnist-cnn", "vgg9-cifar"))


def get_config(arch: str) -> ArchConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown input shape {name!r}; known: "
                       f"{sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "ASSIGNED_ARCHS",
           "get_config", "get_shape", "TRAIN_4K", "PREFILL_32K", "DECODE_32K",
           "LONG_500K"]
