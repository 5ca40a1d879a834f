"""Uplink update compression: top-k sparsification with error feedback
(counterpart of the in-graph half of ``repro/fl/compression.py``).

Clients upload parameter deltas; top-k keeps the k largest-magnitude
entries per leaf and the client carries the rest as a residual (error
feedback). The server folds the cohort's sparse rows into a dense update
with the ``sparse_cohort_add`` kernel, never densifying a client's row.

Selection rule, as in the reference: take the k largest |values|, breaking
magnitude ties toward the LOWER flat index, and send the entries in
ascending index order. ``torch.topk`` leaves its tie order unspecified, so
the rule is enforced with a stable descending sort.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import ops as kernel_ops


def topk_keep(n: int, ratio: float) -> int:
    """Entries kept per leaf."""
    return max(1, int(n * ratio))


def ingraph_topk(flat: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k |values| of a flat vector: largest first, ties to the lower
    index, indices returned ascending. Returns (indices int32 [k],
    values [k])."""
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    idx = torch.sort(order).values
    return idx.to(torch.int32), flat[idx]


def ingraph_sparse_aggregate(idx: torch.Tensor, vals: torch.Tensor,
                             weights: torch.Tensor, length: int
                             ) -> torch.Tensor:
    """Server-side Eq. 1 over K clients' sparse uplinks: dense [length]
    f32 ``sum_i weights[i] * scatter(idx[i], vals[i])`` in one kernel
    launch. idx/vals: [K, k]; weights: [K] normalized."""
    return kernel_ops.sparse_cohort_add(idx.contiguous(), vals.contiguous(),
                                        weights.contiguous(), length)


def ingraph_compress_leaf(flat_start: torch.Tensor, flat_end: torch.Tensor,
                          residual: torch.Tensor, weights: torch.Tensor,
                          ratio: float):
    """One leaf of a compressed round: per-client delta + error feedback
    -> top-k -> one fold over the cohort.

    flat_start: [L] round-start params (f32); flat_end: [K, L] per-client
    trained params (f32); residual: [K, L] carried error feedback; weights:
    [K] normalized Eq. 1 weights. Returns (aggregated [L] f32, new residual
    [K, L], idx [K, k], vals [K, k])."""
    L = flat_start.shape[0]
    k = topk_keep(L, ratio)
    delta = flat_end - flat_start[None, :] + residual
    rows = [ingraph_topk(d, k) for d in delta]
    idx = torch.stack([i for i, _ in rows])
    vals = torch.stack([v for _, v in rows])
    # the kept entries were transmitted exactly, so their residual is zero
    new_residual = delta.scatter(1, idx.long(), 0.0)
    agg = flat_start + ingraph_sparse_aggregate(idx, vals, weights, L)
    return agg, new_residual, idx, vals
