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
        raise NotImplementedError(
            f"arch {arch!r}: the port runs {sorted(_ARCH_MODULES)}; the LM "
            f"families arrive with ROADMAP queue 1, 'Pod path'")
    mod = importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


__all__ = ["ArchConfig", "get_config"]
