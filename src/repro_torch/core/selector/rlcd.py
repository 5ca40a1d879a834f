"""RL-CD: Robust Louvain community detection (paper §IV-C5; counterpart
of ``repro/core/selector/rlcd.py``: the dense path in numpy, the
population-scale sketch path in torch on the card).

Louvain alone groups by coarse label overlap; RL-CD recursively re-partitions
any community whose internal similarity-weight distribution still shows a
clear hierarchy (Standard_stop), after *sharpening* the weights at the median
(paper Step 3: weights below the median are zeroed, above are kept) so the
next Louvain pass separates the sub-structure.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.selector.louvain import louvain
from repro_torch.core.selector.similarity import (label_sketches,
                                                  sketch_projection,
                                                  topm_neighbors)


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


# ---------------------------------------------------------------------------
# Population-scale path: vectorized label propagation over sketch-similarity
# neighbor lists. Louvain/RL-CD above stay the dense small-N oracle (tests
# cross-check the partitions on planted graphs).
# ---------------------------------------------------------------------------


def _lpa_kernel(neighbors: torch.Tensor, weights: torch.Tensor, tol: float,
                *, n_iter: int) -> torch.Tensor:
    n, m = neighbors.shape
    dev = neighbors.device
    nb = neighbors.long()
    labels = torch.arange(n, dtype=torch.int32, device=dev)
    w_all = torch.cat(
        [torch.full((n, 1), 1e-6, dtype=torch.float32, device=dev),  # keep own
         torch.clamp_min(weights, 0.0)], dim=1)         # label when no votes
    relax = 1.0 - torch.tensor(np.float32(tol), device=dev)
    for _ in range(n_iter):
        lab_all = torch.cat([labels[:, None], labels[nb]], dim=1)
        # weighted vote per candidate label: pairwise-equality contraction
        # over the m+1 candidates (O(N * m^2), no N x L vote matrix)
        eq = lab_all[:, :, None] == lab_all[:, None, :]
        votes = (eq * w_all[:, None, :]).sum(2)
        best = votes.amax(1, keepdim=True)
        # relaxed argmax: votes within (1 - tol) of the max count as tied,
        # ties resolve to the SMALLEST label. Synchronous max-vote LPA
        # oscillates / fragments when votes are near-equal (the arbitrary
        # winner freezes sub-splits); letting min-labels percolate through
        # near-ties makes tightly-knit groups converge to one label.
        labels = torch.where(votes >= best * relax, lab_all, n).amin(1)
    return labels


def label_propagation(neighbors, weights, *, n_iter: int = 30,
                      tol: float = 0.05, device=None) -> np.ndarray:
    """Vectorized weighted label propagation on a top-m neighbor graph.

    ``neighbors``/``weights`` are the [N, m] tensors from
    ``similarity.topm_neighbors``; the sweeps run on ``device`` (their own
    device when they are tensors and ``device`` is None, else the card).
    Each sweep every node adopts the label with the largest (non-negative)
    weighted vote among itself and its m neighbors — the whole sweep is one
    [N, m+1, m+1] masked contraction. Votes within ``tol`` (relative) of
    the maximum count as tied and resolve to the smallest label, so the
    fixed ``n_iter``-sweep result is deterministic and near-uniform groups
    coalesce instead of oscillating.

    Returns dense labels renumbered to 0..K-1 (host side).
    """
    if device is None:
        device = neighbors.device if torch.is_tensor(neighbors) else "cuda"
    dev = resolve_device(device)
    labels = _lpa_kernel(torch.as_tensor(neighbors).to(dev, torch.int32),
                         torch.as_tensor(weights).to(dev, torch.float32),
                         tol, n_iter=n_iter).cpu().numpy()
    _, dense = np.unique(labels, return_inverse=True)
    return dense.astype(np.int32)


def _merge_by_centroid(labels: np.ndarray, sketches, *,
                       merge_threshold: float) -> np.ndarray:
    """Louvain-style aggregation level for LPA output: synchronous label
    propagation on a sparse kNN graph provably stalls at domain boundaries
    (a node with one minority-label neighbor can never flip), leaving pure
    but fragmented communities. Contract each community to its sketch
    centroid (numpy f64 on the host), then union communities whose centroid
    cosine clears ``merge_threshold`` — a C x C problem with C << N."""
    if torch.is_tensor(sketches):
        sketches = sketches.cpu().numpy()
    sk = np.asarray(sketches, np.float64)
    sk /= np.maximum(np.linalg.norm(sk, axis=1, keepdims=True), 1e-12)
    c = int(labels.max()) + 1
    cent = np.zeros((c, sk.shape[1]))
    np.add.at(cent, labels, sk)
    cent /= np.maximum(np.linalg.norm(cent, axis=1, keepdims=True), 1e-12)
    adj = cent @ cent.T >= merge_threshold
    # union-find over the (tiny) community graph
    parent = np.arange(c)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i, j in zip(*np.nonzero(np.triu(adj, 1))):
        ri, rj = find(i), find(j)
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)
    roots = np.asarray([find(i) for i in range(c)])
    _, dense = np.unique(roots, return_inverse=True)
    return dense[labels].astype(np.int32)


def sketch_communities(label_histograms: np.ndarray, *, sketch_dim: int = 64,
                       num_neighbors: int = 8, n_iter: int = 30,
                       seed: int = 0, block_rows: int = 4096,
                       merge_threshold: float = 0.9, device="cuda"
                       ) -> Tuple[np.ndarray, int]:
    """End-to-end population-scale community detection on ``device``:
    hashed label-distribution sketches -> tiled top-m cosine neighbors ->
    vectorized label propagation -> centroid merge. O(N^2 / block) flops but
    O(N * m) memory; never materializes the dense similarity matrix RL-CD
    needs.

    Returns (community_id [N], n_communities).
    """
    hist = np.asarray(label_histograms, np.float32)
    proj = sketch_projection(hist.shape[1], sketch_dim, seed)
    sketches = label_sketches(hist, proj, device=device)
    nb, w = topm_neighbors(sketches, num_neighbors, block_rows=block_rows)
    labels = label_propagation(nb, w, n_iter=n_iter)
    if labels.max() > 0:
        labels = _merge_by_centroid(labels, sketches,
                                    merge_threshold=merge_threshold)
    return labels, (int(labels.max()) + 1 if len(labels) else 0)
