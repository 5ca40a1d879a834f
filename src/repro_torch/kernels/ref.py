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


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: torch.Tensor, *, scale=None) -> torch.Tensor:
    """One-token attention over a cache, q [B, Hq, d], k/v [B, S, Hkv, d],
    length [B]: kv heads repeated to Hq (q head h reads kv head
    h // (Hq / Hkv)), f32 scores, columns >= length masked to -1e30, rows
    with length == 0 exact zeros, output in q's dtype."""
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads {Hkv}")
    g = Hq // Hkv
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, None, :]
             < length[:, None, None])
    s = s.masked_fill(~valid, -1e30)
    p = torch.where(length[:, None, None] > 0, torch.softmax(s, dim=-1), 0.0)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)
