"""Plain PyTorch versions of the port's kernels (counterpart of
``repro/kernels/ref.py``). The CPU path and the tests use them; on the card
``chip_smoke.py`` holds each kernel against them, and nothing on the
card's main path calls them."""
from __future__ import annotations

from typing import Tuple

import torch


def sparse_cohort_add_ref(idx: torch.Tensor, vals: torch.Tensor,
                          weights: torch.Tensor, length: int) -> torch.Tensor:
    """Dense [length] f32 fold of K sparse client rows:
    ``sum_i weights[i] * scatter(idx[i], vals[i])``, duplicate indices
    accumulating (the scatter-add of ``ingraph_sparse_aggregate``)."""
    contrib = (weights.float()[:, None] * vals.float()).reshape(-1)
    return torch.zeros(length, dtype=torch.float32, device=vals.device
                       ).index_add_(0, idx.reshape(-1).long(), contrib)


def diff_sqnorm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum((a - b)^2)`` over the flattened operands as a 0-dim float64
    tensor: each operand widened to f32 and the difference taken in f32,
    as the reference's ``diff_sqnorm_ref`` and numpy's ``flat - prev`` do;
    the square and the sum in f64, as the reference's numpy observe
    (``np.square(v, dtype=np.float64)``)."""
    d = (a.reshape(-1).float() - b.reshape(-1).float()).double()
    return torch.sum(d * d)


def normalize_scale(scale: torch.Tensor, M: int, K: int
                    ) -> Tuple[str, torch.Tensor]:
    """Classify a scale broadcastable to q [M, K] as ``(kind, 2-D view)``,
    the port's copy of ``repro/kernels/dequant_matmul.py:normalize_scale``
    with its order of checks: a 0-d, ``(1,)`` or ``(1, 1)`` scale is a
    broadcast column scale ``[1, K]``; a 1-D scale of length K is a column
    scale (even when M == K), of length M a row scale; ``[M, 1]`` is
    ``row``, ``[1, K]`` ``col``, ``[M, K]`` ``full``. The view shares the
    caller's tensor, so a gradient through it lands in the caller's shape.
    Anything else raises ``ValueError``."""
    shape = tuple(scale.shape)
    if scale.dim() == 0 or shape in ((1,), (1, 1)):
        return "col", scale.reshape(1, 1).expand(1, K)
    if scale.dim() == 1:
        if shape[0] == K:
            return "col", scale.reshape(1, K)
        if shape[0] == M:
            return "row", scale.reshape(M, 1)
    if scale.dim() == 2:
        if shape == (M, 1):
            return "row", scale
        if shape == (1, K):
            return "col", scale
        if shape == (M, K):
            return "full", scale
    raise ValueError(
        f"scale shape {shape} not broadcastable to q ({M}, {K}); reshape "
        "higher-rank quantizer scales to the GEMM layout first")


def dequant_matmul_ref(q: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q.float() * scale.float()) @ w.float()`` with f32 accumulation,
    cast to ``out_dtype`` (the reference's ``dequant_matmul_ref``). q
    [M, K] int8, f32 or bf16; scale as ``normalize_scale`` takes it; w
    [K, N]. Differentiable in scale and w."""
    if q.dim() != 2 or w.dim() != 2 or q.shape[1] != w.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} and w {tuple(w.shape)} do not "
                         "make a [M, K] @ [K, N] product")
    _, s = normalize_scale(scale, q.shape[0], q.shape[1])
    return ((q.float() * s.float()) @ w.float()).to(out_dtype)


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
    """One-token attention over a cache, q [B, Hq, dk], k [B, S, Hkv, dk],
    v [B, S, Hkv, dv], length [B] -> [B, Hq, dv]: kv heads repeated to Hq
    (q head h reads kv head h // (Hq / Hkv)), f32 scores, columns >=
    length masked to -1e30, rows with length == 0 exact zeros, output in
    q's dtype."""
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


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence, one step at a time (exact): x [B, S, H, hd];
    dt, log_a [B, S, H]; Bm, Cm [B, S, N] -> y [B, S, H, hd] in x's dtype.
    ``h_t = exp(log_a_t) h_{t-1} + dt_t x_t B_t^T`` and ``y_t = h_t C_t``,
    the state h [B, H, hd, N] and every product in f32."""
    B, S, H, hd = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, hd, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        a = torch.exp(log_a[:, t].float())
        h = a[..., None, None] * h + torch.einsum(
            "bh,bhd,bN->bhdN", dt[:, t].float(), x[:, t].float(),
            Bm[:, t].float())
        ys.append(torch.einsum("bN,bhdN->bhd", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype)


def segsum(log_a: torch.Tensor) -> torch.Tensor:
    """Stable segment sum: out[..., i, j] = sum_{k=j+1..i} log_a[..., k] for
    i >= j, -inf above the diagonal. log_a [..., L] -> [..., L, L]."""
    L = log_a.shape[-1]
    cum = torch.cumsum(log_a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.ones(L, L, dtype=torch.bool, device=log_a.device).tril()
    return diff.masked_fill(~mask, -torch.inf)


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, *, chunk: int
                    ) -> torch.Tensor:
    """The same function in the reference model's chunked form
    (``repro/models/ssm.py:_ssd_chunked``): quadratic within each chunk of
    ``chunk`` rows (S % chunk == 0), a recurrence over chunk states, all in
    f32 with log-space decay. Differentiable; the scan kernel's backward is
    autograd through it."""
    Bsz, S, H, hd = x.shape
    N = Bm.shape[-1]
    assert S % chunk == 0, (S, chunk)
    n = S // chunk
    xc = x.reshape(Bsz, n, chunk, H, hd).float()
    Bc = Bm.reshape(Bsz, n, chunk, N).float()
    Cc = Cm.reshape(Bsz, n, chunk, N).float()
    dtc = dt.reshape(Bsz, n, chunk, H)
    lac = log_a.reshape(Bsz, n, chunk, H)

    # intra-chunk: y_intra[i] = sum_{j<=i} C_i.B_j L_ij dt_j x_j
    Lseg = segsum(lac.permute(0, 1, 3, 2))  # [B, n, H, c, c]
    att = torch.einsum("bncN,bnmN->bncm", Cc, Bc)[:, :, None] * torch.exp(Lseg)
    y_intra = torch.einsum("bnhcm,bnmh,bnmhd->bnchd", att, dtc, xc)

    # chunk-final states: S_k = sum_j prod_{l>j} a_l dt_j x_j B_j^T
    tail = torch.cumsum(lac, dim=2)
    tail = tail[:, :, -1:, :] - tail
    w = torch.exp(tail) * dtc  # [B, n, c, H]
    chunk_state = torch.einsum("bnch,bnchd,bncN->bnhdN", w, xc, Bc)
    chunk_decay = torch.exp(torch.sum(lac, dim=2))  # [B, n, H]

    # inter-chunk recurrence: the state entering each chunk
    h = torch.zeros((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
    h_enter = []
    for k in range(n):
        h_enter.append(h)
        h = chunk_decay[:, k, :, None, None] * h + chunk_state[:, k]
    h_enter = torch.stack(h_enter, dim=1)  # [B, n, H, hd, N]

    # inter-chunk contribution: y_inter[i] = C_i . (prod_{l<=i} a_l) h_enter
    head = torch.cumsum(lac, dim=2)
    y_inter = torch.einsum("bncN,bnch,bnhdN->bnchd", Cc, torch.exp(head),
                           h_enter)
    y = (y_intra + y_inter).reshape(Bsz, S, H, hd)
    return y.to(x.dtype)
