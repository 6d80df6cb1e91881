"""Offline-safe synthetic datasets (numpy only).

Class-conditional images with the exact shapes of the paper's datasets
(FMNIST 28x28x1 / CIFAR 32x32x3, 10 classes): each class is a fixed
random template plus structured noise and random shifts.  Token
documents for the LM trainer: a mixture of bigram models with a topic
per document.  The draws consume the caller's numpy generator exactly
as the reference's ``repro/data/synthetic.py`` does, so one seed gives
the same arrays.
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


def make_image_dataset(rng: np.random.Generator, n: int, *, shape,
                       n_classes: int = 10, noise: float = 0.25
                       ) -> ImageDataset:
    templates = _class_templates(rng, n_classes, shape)
    return _sample_from_templates(rng, templates, n, noise)


def make_token_dataset(rng: np.random.Generator, n_docs: int, seq_len: int,
                       vocab: int, n_topics: int = 8) -> np.ndarray:
    """(n_docs, seq_len) int32 token documents from topic bigram models.
    The bigram table is ``(n_topics, vocab, vocab)`` float64, as in the
    reference: 16 MB at the reduced configs' vocab of 512, but 66 GB at
    phi3-mini-3.8b's 32064, so the published vocabularies train on other
    tokens."""
    probs = rng.dirichlet(np.full(vocab, 0.05), size=(n_topics, vocab))
    topics = rng.integers(0, n_topics, size=n_docs)
    docs = np.zeros((n_docs, seq_len), np.int32)
    docs[:, 0] = rng.integers(0, vocab, size=n_docs)
    for t in range(1, seq_len):
        rows = probs[topics, docs[:, t - 1]]
        cum = np.cumsum(rows, axis=-1)
        u = rng.uniform(size=(n_docs, 1))
        docs[:, t] = (u > cum).sum(-1)
    return np.clip(docs, 0, vocab - 1)
