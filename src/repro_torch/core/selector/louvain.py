"""Louvain modularity maximization (Blondel et al. 2008), from scratch
(numpy copy of ``repro/core/selector/louvain.py``).

Operates on a dense non-negative weight matrix (client similarity). One level
of local moving + graph aggregation, repeated until modularity stops
improving.
"""
from __future__ import annotations

from typing import List

import numpy as np


def louvain(W: np.ndarray, *, resolution: float = 1.0, seed: int = 0,
            max_levels: int = 10) -> List[List[int]]:
    """Returns communities as lists of original node indices."""
    n = W.shape[0]
    W = np.asarray(W, np.float64).copy()
    np.fill_diagonal(W, 0.0)
    W = np.maximum(W, 0.0)  # Louvain needs non-negative weights
    membership = list(range(n))  # original node -> community label
    node_groups = [[i] for i in range(n)]  # current super-node -> original nodes
    rng = np.random.RandomState(seed)

    for _ in range(max_levels):
        labels, improved = _one_level(W, resolution, rng)
        uniq = sorted(set(labels))
        if not improved or len(uniq) == W.shape[0]:
            break
        # aggregate — KEEP self-loops: intra-community weight must stay in the
        # supernode degree or the next level over-merges
        remap = {c: k for k, c in enumerate(uniq)}
        labels = [remap[c] for c in labels]
        m = len(uniq)
        new_groups: List[List[int]] = [[] for _ in range(m)]
        for sn, lab in enumerate(labels):
            new_groups[lab].extend(node_groups[sn])
        Wn = np.zeros((m, m))
        for i in range(W.shape[0]):
            for j in range(W.shape[0]):
                Wn[labels[i], labels[j]] += W[i, j]
        node_groups = new_groups
        W = Wn
        if m <= 1:
            break
    for k, grp in enumerate(node_groups):
        for orig in grp:
            membership[orig] = k
    out: List[List[int]] = [[] for _ in range(len(node_groups))]
    for orig, c in enumerate(membership):
        out[c].append(orig)
    return [sorted(c) for c in out if c]


def _one_level(W: np.ndarray, resolution: float, rng) -> tuple:
    n = W.shape[0]
    deg = W.sum(axis=1)
    two_m = deg.sum()
    if two_m <= 0:
        return list(range(n)), False
    labels = np.arange(n)
    comm_deg = deg.copy()  # total degree per community
    improved_any = False
    for _ in range(20):
        moved = False
        order = rng.permutation(n)
        for v in order:
            c_old = labels[v]
            comm_deg[c_old] -= deg[v]
            # weights from v to each community
            w_to = {}
            for u in range(n):
                if u != v and W[v, u] > 0:
                    w_to[labels[u]] = w_to.get(labels[u], 0.0) + W[v, u]
            best_c, best_gain = c_old, w_to.get(c_old, 0.0) - \
                resolution * comm_deg[c_old] * deg[v] / two_m
            for c, w in w_to.items():
                gain = w - resolution * comm_deg[c] * deg[v] / two_m
                if gain > best_gain + 1e-12:
                    best_gain, best_c = gain, c
            labels[v] = best_c
            comm_deg[best_c] += deg[v]
            if best_c != c_old:
                moved = True
                improved_any = True
        if not moved:
            break
    return list(labels), improved_any
