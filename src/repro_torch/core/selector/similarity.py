"""Client similarity from output-layer gradients (paper Eq. 8) and its
population-scale sketch approximation (counterpart of
``repro/core/selector/similarity.py``).

Each client trains ONLY the global model's output layer for a few steps on
local data and reports that gradient vector once (memory-cheap: no backprop
through the body). Cosine similarity between these vectors tracks label
distribution similarity — the basis for RL-CD community detection.

The dense N x N ``similarity_matrix`` (numpy f64) is the small-N oracle. At
population scale the same signal is carried by each client's *label
distribution* (which is what the output-layer gradient tracks): clients
report a ``sketch_dim``-sized count-sketch of their normalized label
histogram, and similarity is evaluated lazily in row blocks on the device
(a tiled f32 matmul, TF32 off, + a per-row stable top-m) so only the top-m
neighbor lists — O(N * m), not O(N^2) — ever materialize. Those neighbor
lists feed the vectorized label propagation in rlcd.py.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.models.module import tree_leaves, tree_unflatten


def output_layer_gradient(loss_head_fn: Callable, head_params, data
                          ) -> np.ndarray:
    """Gradient of the loss wrt output-layer params only, flattened in leaf
    order (sorted keys, as ``jax.tree.leaves``) as one f32 vector. A leaf
    the loss never reads contributes zeros, as ``jax.grad`` gives it."""
    leaves = [l.detach().requires_grad_(True)
              for l in tree_leaves(head_params)]
    loss = loss_head_fn(tree_unflatten(head_params, leaves), data)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return np.concatenate([
        (torch.zeros_like(l) if g is None else g).detach().cpu().numpy()
        .astype(np.float32).ravel() for l, g in zip(leaves, grads)])


def similarity_matrix(grads: Dict[int, np.ndarray]) -> np.ndarray:
    """Omega[i, j] = cosine similarity of client gradient vectors (Eq. 8)."""
    ids = sorted(grads)
    G = np.stack([grads[i] for i in ids]).astype(np.float64)
    norms = np.linalg.norm(G, axis=1, keepdims=True)
    G = G / np.maximum(norms, 1e-12)
    return G @ G.T


# ---------------------------------------------------------------------------
# Hashed label-distribution sketches
# ---------------------------------------------------------------------------


def sketch_projection(num_classes: int, sketch_dim: int, seed: int = 0, *,
                      n_hashes: int = 4) -> np.ndarray:
    """Sparse signed hash projection [num_classes, sketch_dim]: each class
    hashes to ``n_hashes`` signed buckets (sparse Johnson-Lindenstrauss),
    so sketching is one sparse matmul and sketch cosine approximates
    histogram cosine. A single hash (classic count-sketch) makes a bucket
    collision between two classes catastrophic — their histograms become
    fully (anti-)correlated; with ``n_hashes`` independent buckets the
    distortion of any pair is averaged down by 1/n_hashes."""
    rng = np.random.RandomState(seed)
    P = np.zeros((num_classes, sketch_dim), np.float32)
    for _ in range(n_hashes):
        bucket = rng.randint(0, sketch_dim, size=num_classes)
        sign = rng.choice(np.asarray([-1.0, 1.0], np.float32),
                          size=num_classes)
        P[np.arange(num_classes), bucket] += sign / np.sqrt(n_hashes)
    return P


def label_sketches(histograms: np.ndarray, projection: np.ndarray, *,
                   device="cuda") -> torch.Tensor:
    """[N, num_classes] label histograms -> [N, sketch_dim] f32 sketches of
    the normalized label distributions, on ``device``."""
    dev = resolve_device(device)
    h = np.asarray(histograms, np.float32)
    h = h / np.maximum(h.sum(axis=1, keepdims=True), 1.0)
    return (torch.from_numpy(h).to(dev)
            @ torch.from_numpy(np.asarray(projection, np.float32)).to(dev))


def _block_topm(block, vecs_t, row_offset: int, *, m: int):
    """Each row's top-m columns of ``block @ vecs_t`` (its own column
    masked), in ``lax.top_k``'s order: by value, ties toward the lower
    column. ``torch.topk`` promises no order among equal values, so it only
    fixes the m-th value v; the columns kept are every one above v and
    the lowest-indexed ones equal to v, and a stable sort of those m (in
    ascending column order) by value gives the order."""
    sims = block @ vecs_t                                # [B, N] tile
    b, n = sims.shape
    rows = torch.arange(b, device=sims.device)
    sims[rows, row_offset + rows] = -torch.inf           # mask self
    v = torch.topk(sims, m, dim=1).values[:, -1:]
    above = sims > v
    at = sims == v
    need = m - above.sum(1, keepdim=True, dtype=torch.int32)
    keep = above | (at & (torch.cumsum(at, 1, dtype=torch.int32) <= need))
    # the kept columns in ascending order: distinct keys n - j, 0 elsewhere
    col = torch.arange(n, 0, -1, dtype=torch.int32, device=sims.device)
    cols = n - torch.topk(torch.where(keep, col, 0), m, dim=1).values.long()
    w, order = torch.sort(sims.gather(1, cols), dim=1, descending=True,
                          stable=True)
    return cols.gather(1, order).to(torch.int32), w


def topm_neighbors(vecs, m: int, *, block_rows: int = 4096,
                   max_tile_bytes: int = 128 << 20, device=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-m cosine neighbors per row without materializing N x N: the
    similarity matrix is computed one [block_rows, N] tile at a time and
    immediately reduced to its top m. Returns ([N, m] i32 neighbor indices,
    [N, m] f32 cosine weights) on ``device`` (``vecs``' own device when it
    is a tensor and ``device`` is None, else the card).

    ``block_rows`` is a ceiling — the effective block shrinks so one f32
    tile stays under ``max_tile_bytes`` (otherwise a 4096-row block at
    N=100k would transiently allocate ~1.6 GB, defeating the O(N*m)
    memory claim)."""
    if device is None:
        device = vecs.device if torch.is_tensor(vecs) else "cuda"
    dev = resolve_device(device)
    vecs = torch.as_tensor(vecs, dtype=torch.float32).to(dev)
    n = vecs.shape[0]
    m = min(m, n - 1)
    block_rows = max(1, min(block_rows, max_tile_bytes // max(4 * n, 1)))
    norms = torch.sqrt((vecs * vecs).sum(1, keepdim=True))
    unit = vecs / torch.clamp_min(norms, 1e-12)
    unit_t = unit.T.contiguous()
    idx_blocks, w_blocks = [], []
    for lo in range(0, n, block_rows):
        hi = min(lo + block_rows, n)
        idx_b, w_b = _block_topm(unit[lo:hi], unit_t, lo, m=m)
        idx_blocks.append(idx_b)
        w_blocks.append(w_b)
    return torch.cat(idx_blocks), torch.cat(w_blocks)
