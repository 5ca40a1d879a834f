"""Client similarity from output-layer gradients (paper Eq. 8; the dense
numpy oracle of ``repro/core/selector/similarity.py``).

Each client reports the gradient of its local loss with respect to the
global model's output layer once; cosine similarity between these vectors
tracks label-distribution similarity and feeds RL-CD.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def similarity_matrix(grads: Dict[int, np.ndarray]) -> np.ndarray:
    """Omega[i, j] = cosine similarity of client gradient vectors (Eq. 8)."""
    ids = sorted(grads)
    G = np.stack([grads[i] for i in ids]).astype(np.float64)
    norms = np.linalg.norm(G, axis=1, keepdims=True)
    G = G / np.maximum(norms, 1e-12)
    return G @ G.T
