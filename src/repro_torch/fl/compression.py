"""Uplink update compression: top-k sparsification with error feedback
(counterpart of ``repro/fl/compression.py``).

Clients upload parameter deltas; top-k keeps the k largest-magnitude
entries per leaf and the client carries the rest as a residual (error
feedback). Two implementations share one selection rule:

  * the host API (``topk_compress``/``topk_decompress``/``ErrorFeedback``):
    numpy payloads, the wire format of a real deployment. No round of the
    port calls it;
  * the in-graph path (``ingraph_topk``/``ingraph_compress_leaf``), which
    the engine runs on the params' device: the server folds the cohort's
    sparse rows into a dense update with the ``sparse_cohort_add`` kernel,
    never densifying a client's row.

Selection rule, as in the reference: take the k largest |values|, breaking
magnitude ties toward the LOWER flat index, and send the entries in
ascending index order. ``torch.topk`` leaves its tie order unspecified, so
the rule is enforced with a stable descending sort (a stable argsort of
``-|flat|`` on the host).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten


def topk_keep(n: int, ratio: float) -> int:
    """Entries kept per leaf."""
    return max(1, int(n * ratio))


# ---------------------------------------------------------------------------
# Host API (numpy payloads)
# ---------------------------------------------------------------------------


def deterministic_topk_indices(flat: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k largest |values|, ties to the lower index, returned
    ascending."""
    order = np.argsort(-np.abs(flat), kind="stable")[:k]
    return np.sort(order)


def topk_compress(delta, ratio: float) -> Dict:
    """Keep the top ``ratio`` fraction of entries per leaf. Returns
    ``{leaf index: (indices int32, values float32, shape)}`` with indices
    ascending, leaves in ``tree_leaves`` order."""
    out = {}
    for i, leaf in enumerate(tree_leaves(delta)):
        flat = leaf.detach().float().cpu().numpy().ravel()
        idx = deterministic_topk_indices(flat, topk_keep(len(flat), ratio))
        out[i] = (idx.astype(np.int32), flat[idx], tuple(leaf.shape))
    return out


def topk_decompress(sparse: Dict, treedef_like):
    """The dense tree of ``sparse``: ``treedef_like``'s structure, each
    leaf in its template's dtype on its template's device."""
    leaves = []
    for i, leaf in enumerate(tree_leaves(treedef_like)):
        idx, vals, shape = sparse[i]
        flat = np.zeros(int(np.prod(shape)), np.float32)
        flat[idx] = vals
        leaves.append(torch.as_tensor(flat.reshape(shape)).to(
            device=leaf.device, dtype=leaf.dtype))
    return tree_unflatten(treedef_like, leaves)


def compressed_bytes(sparse: Dict) -> int:
    return sum(idx.nbytes + vals.nbytes for idx, vals, _ in sparse.values())


@dataclass
class ErrorFeedback:
    """Per-client residual accumulator for biased compressors (host path);
    the residual is f32."""

    ratio: float = 0.01
    _residual: Optional[object] = None

    def compress(self, delta) -> Tuple[Dict, object]:
        if self._residual is not None:
            delta = tree_map(lambda d, r: d + r, delta, self._residual)
        sparse = topk_compress(delta, self.ratio)
        decompressed = topk_decompress(sparse, delta)
        self._residual = tree_map(lambda d, q: d.float() - q.float(), delta,
                                  decompressed)
        return sparse, decompressed


# ---------------------------------------------------------------------------
# In-graph path (consumed by fl/engine.py)
# ---------------------------------------------------------------------------


def ingraph_topk(flat: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k |values| of a flat vector: largest first, ties to the lower
    index, indices returned ascending. Returns (indices int32 [k],
    values [k])."""
    order = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    idx = torch.sort(order).values
    return idx.to(torch.int32), flat[idx]


def ingraph_sparse_aggregate(idx: torch.Tensor, vals: torch.Tensor,
                             weights: torch.Tensor, length: int, *,
                             sorted_rows: bool = False) -> torch.Tensor:
    """Server-side Eq. 1 over K clients' sparse uplinks: dense [length]
    f32 ``sum_i weights[i] * scatter(idx[i], vals[i])`` in one kernel
    launch, summed in client order. idx/vals: [K, k]; weights: [K]
    normalized. ``sorted_rows=True`` when every row of idx ascends, as
    ``ingraph_topk`` sends it: the fold then runs no sort first
    (``kernels/sparse_agg.py``)."""
    return kernel_ops.sparse_cohort_add(idx.contiguous(), vals.contiguous(),
                                        weights.contiguous(), length,
                                        sorted_rows=sorted_rows)


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
    agg = flat_start + ingraph_sparse_aggregate(idx, vals, weights, L,
                                                sorted_rows=True)
    return agg, new_residual, idx, vals
