"""Dispatch for the port's kernels (counterpart of ``repro/kernels/ops.py``).

A CUDA tensor goes to the kernel, which launches or raises. A CPU tensor
takes the kernel's plain version in ``kernels/ref.py``, and that is the
only case in which the plain version runs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, sparse_agg


def sparse_cohort_add(idx: torch.Tensor, vals: torch.Tensor,
                      weights: torch.Tensor, length: int) -> torch.Tensor:
    """Dense [length] f32 fold of K clients' top-k (idx, vals) rows, the
    compressed-uplink Eq. 1 aggregation (``kernels/sparse_agg.py``)."""
    if idx.device.type == "cpu":
        return ref.sparse_cohort_add_ref(idx, vals, weights, length)
    return sparse_agg.sparse_cohort_add(idx, vals, weights, length)
