"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``). The CPU path and the tests use them; on the card
``chip_smoke.py`` holds each kernel against them, and nothing on the
card's main path calls them."""
from __future__ import annotations

import torch


def sparse_cohort_add_ref(idx: torch.Tensor, vals: torch.Tensor,
                          weights: torch.Tensor, length: int) -> torch.Tensor:
    """Dense [length] f32 fold of K sparse client rows:
    ``sum_i weights[i] * scatter(idx[i], vals[i])``, duplicate indices
    accumulating (the scatter-add of ``ingraph_sparse_aggregate``)."""
    contrib = (weights.float()[:, None] * vals.float()).reshape(-1)
    return torch.zeros(length, dtype=torch.float32, device=vals.device
                       ).index_add_(0, idx.reshape(-1).long(), contrib)
