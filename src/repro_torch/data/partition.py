"""Federated dataset partitioning: IID and Dirichlet non-IID ([34]).

numpy only; consumes the generator exactly as ``repro/data/partition.py``.
"""
from __future__ import annotations

import numpy as np


def partition_iid(rng: np.random.Generator, n_samples: int, n_clients: int
                  ) -> list[np.ndarray]:
    idx = rng.permutation(n_samples)
    return [np.sort(s) for s in np.array_split(idx, n_clients)]


def partition_dirichlet(rng: np.random.Generator, labels: np.ndarray,
                        n_clients: int, alpha: float = 0.5,
                        min_size: int = 2) -> list[np.ndarray]:
    """Label-Dirichlet partition (FedMA-style, paper's non-IID setting)."""
    n_classes = int(labels.max()) + 1
    while True:
        buckets: list[list[int]] = [[] for _ in range(n_clients)]
        for cls in range(n_classes):
            cls_idx = np.where(labels == cls)[0]
            rng.shuffle(cls_idx)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(cls_idx)).astype(int)[:-1]
            for b, part in zip(buckets, np.split(cls_idx, cuts)):
                b.extend(part.tolist())
        sizes = [len(b) for b in buckets]
        if min(sizes) >= min_size:
            return [np.sort(np.asarray(b)) for b in buckets]
