"""RL-CD: Robust Louvain community detection (paper §IV-C5; the dense
numpy path of ``repro/core/selector/rlcd.py``).

Louvain alone groups by coarse label overlap; RL-CD recursively re-partitions
any community whose internal similarity-weight distribution still shows a
clear hierarchy (Standard_stop), after *sharpening* the weights at the median
(paper Step 3: weights below the median are zeroed, above are kept) so the
next Louvain pass separates the sub-structure.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.selector.louvain import louvain


def _has_weight_hierarchy(w: np.ndarray, *, gap_factor: float = 1.2,
                          min_edges: int = 3) -> bool:
    """Standard_stop check: does the weight distribution split into clearly
    separated low/high groups? 2-means separation vs within-spread test."""
    w = w[w > 0]
    if w.size < min_edges:
        return False
    lo, hi = w.min(), w.max()
    if hi - lo < 1e-9:
        return False
    # 2-means on 1-D weights
    c0, c1 = lo, hi
    for _ in range(20):
        assign = np.abs(w - c0) <= np.abs(w - c1)
        if assign.all() or (~assign).all():
            return False
        n0, n1 = w[assign], w[~assign]
        c0n, c1n = n0.mean(), n1.mean()
        if abs(c0n - c0) + abs(c1n - c1) < 1e-12:
            break
        c0, c1 = c0n, c1n
    spread = max(n0.std(), n1.std(), 1e-9)
    return abs(c1 - c0) > gap_factor * spread


def _sharpen(W: np.ndarray) -> np.ndarray:
    """Median-threshold sharpening (paper Step 3)."""
    vals = W[np.triu_indices_from(W, k=1)]
    vals = vals[vals > 0]
    if vals.size == 0:
        return W
    med = np.median(vals)
    Ws = W.copy()
    Ws[Ws < med] = 0.0
    return Ws


def rlcd_communities(W: np.ndarray, *, max_depth: int = 4,
                     min_size: int = 2, seed: int = 0) -> List[List[int]]:
    """Full RL-CD: iterative Louvain + sharpening until Standard_stop holds
    in every community. Returns communities of original indices."""
    W = np.asarray(W, np.float64)
    n = W.shape[0]
    Wp = np.maximum(W.copy(), 0.0)
    np.fill_diagonal(Wp, 0.0)

    final: List[List[int]] = []
    stack = [(list(range(n)), 0)]
    while stack:
        nodes, depth = stack.pop()
        if len(nodes) <= min_size or depth >= max_depth:
            final.append(sorted(nodes))
            continue
        sub = Wp[np.ix_(nodes, nodes)]
        w_flat = sub[np.triu_indices_from(sub, k=1)]
        if depth > 0 and not _has_weight_hierarchy(w_flat):
            final.append(sorted(nodes))  # Standard_stop met
            continue
        use = _sharpen(sub) if depth > 0 else sub
        comms = louvain(use, seed=seed + depth)
        if len(comms) <= 1:
            if depth == 0:
                final.append(sorted(nodes))
                continue
            # sharpened graph didn't split: stop here
            final.append(sorted(nodes))
            continue
        for c in comms:
            stack.append(([nodes[i] for i in c], depth + 1))
    return sorted(final, key=lambda c: c[0])
