"""Offline-safe synthetic image datasets (numpy only).

Class-conditional data with the exact shapes of the paper's datasets
(FMNIST 28x28x1 / CIFAR 32x32x3, 10 classes): each class is a fixed
random template plus structured noise and random shifts.  The draws
consume the caller's numpy generator exactly as the reference's
``repro/data/synthetic.py`` does, so one seed gives the same arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageDataset:
    x: np.ndarray       # (N, H, W, C) float32 in [0,1]
    y: np.ndarray       # (N,) int32


def _class_templates(rng: np.random.Generator, n_classes: int, shape
                     ) -> np.ndarray:
    h, w, c = shape
    templates = rng.normal(0.5, 0.5, size=(n_classes, h, w, c))
    # low-frequency smoothing of templates so shifts matter
    for _ in range(2):
        templates = (templates
                     + np.roll(templates, 1, 1) + np.roll(templates, -1, 1)
                     + np.roll(templates, 1, 2) + np.roll(templates, -1, 2)
                     ) / 5.0
    return templates


def _sample_from_templates(rng: np.random.Generator, templates: np.ndarray,
                           n: int, noise: float) -> ImageDataset:
    n_classes = templates.shape[0]
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = templates[y].copy()
    # random small translations
    sx = rng.integers(-2, 3, size=n)
    sy = rng.integers(-2, 3, size=n)
    for i in range(n):
        x[i] = np.roll(np.roll(x[i], sx[i], 0), sy[i], 1)
    x = x + rng.normal(0, noise, size=x.shape)
    x = np.clip(x, 0.0, 1.0).astype(np.float32)
    return ImageDataset(x, y)


def make_image_task(rng: np.random.Generator, n_train: int, n_test: int, *,
                    shape, n_classes: int = 10, noise: float = 0.25
                    ) -> tuple[ImageDataset, ImageDataset]:
    """Train/test splits drawn from *shared* class templates."""
    templates = _class_templates(rng, n_classes, shape)
    train = _sample_from_templates(rng, templates, n_train, noise)
    test = _sample_from_templates(rng, templates, n_test, noise)
    return train, test
