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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, scale=None) -> torch.Tensor:
    """Softmax attention, q [B, S, Hq, d], k/v [B, S, Hkv, d]: kv heads
    repeated to Hq (q head h reads kv head h // (Hq / Hkv)), f32 scores,
    masked entries -1e30, output in q's dtype."""
    B, S, Hq, d = q.shape
    g = Hq // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
