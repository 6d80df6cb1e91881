"""Config registry: ``--arch <id>`` resolution (the paper's own models)."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ArchConfig

_ARCH_MODULES = {
    "fmnist-cnn": "fmnist_cnn",
    "vgg9-cifar": "vgg9_cifar",
}


def get_config(arch: str) -> ArchConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port knows "
                       f"{sorted(_ARCH_MODULES)} (the LM families arrive "
                       f"with the pod path, ROADMAP queue 1)")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ArchConfig", "get_config"]
