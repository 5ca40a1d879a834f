"""Client data partitioning: IID and Dirichlet(alpha) non-IID (paper §V-A;
numpy copy of ``repro/data/partition.py``)."""
from __future__ import annotations

from typing import List

import numpy as np


def iid_partition(labels: np.ndarray, num_clients: int, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def dirichlet_partition(labels: np.ndarray, num_clients: int, alpha: float = 1.0,
                        seed: int = 0, min_per_client: int = 2) -> List[np.ndarray]:
    """Label-skew non-IID: per class, split indices by Dirichlet(alpha) shares
    (smaller alpha = more skew; paper uses alpha=1)."""
    rng = np.random.RandomState(seed)
    classes = np.unique(labels)
    shares = [[] for _ in range(num_clients)]
    for c in classes:
        idx = np.where(labels == c)[0]
        rng.shuffle(idx)
        p = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(p) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            shares[cid].extend(part.tolist())
    # ensure every client has a floor of samples
    pool = [i for s in shares for i in s]
    for cid in range(num_clients):
        while len(shares[cid]) < min_per_client:
            shares[cid].append(pool[rng.randint(len(pool))])
    return [np.sort(np.asarray(s)) for s in shares]


def label_distribution(labels: np.ndarray, parts: List[np.ndarray],
                       num_classes: int) -> np.ndarray:
    """[num_clients, num_classes] empirical label histogram (for Fig.6/9)."""
    out = np.zeros((len(parts), num_classes))
    for i, p in enumerate(parts):
        for c in range(num_classes):
            out[i, c] = np.sum(labels[p] == c)
    return out / np.maximum(out.sum(1, keepdims=True), 1)
