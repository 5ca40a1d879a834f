"""State-space and recurrent layers (counterpart of ``repro/models/ssm.py``):
Mamba2 (SSD) and xLSTM's mLSTM and sLSTM blocks.

The full-sequence forwards run chunked forms (quadratic within a chunk,
recurrent across chunks), so no S x S matrix is ever held; decode is the
O(1)-state one-step recurrence. All recurrence math is f32 with log-space
decay and max stabilizers.

On the card every ``_ssd_chunked`` call goes through the scan kernel
(``kernels/ops.py:ssd_scan``, kernel B5), whose backward is autograd
through the same chunked form; on the CPU it runs the reference's chunked
einsums (``kernels/ref.py:ssd_chunked_ref``). xLSTM has no kernel of its
own: mLSTM's chunked form and sLSTM's cell are plain PyTorch on both
devices. The reference's scans over chunks (mLSTM) and over time steps
(sLSTM) are Python loops, so on the card an sLSTM forward is S cells
launched from the host. One decode step writes the layer's state in place,
as the attention decode writes its KV cache.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_init,
                                       causal_conv1d_step, dense, dense_init,
                                       gelu, rmsnorm, rmsnorm_init, silu)
from repro_torch.models.module import ParamFactory, Params

SSM_CHUNK = 256


def _widths(cfg) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim, cfg.ssm_state


def mamba2_init(fac: ParamFactory, cfg) -> Params:
    d_inner, nheads, N = _widths(cfg)
    D = cfg.d_model
    conv_ch = d_inner + 2 * N  # x, B, C all convolved
    return {
        "in_proj": dense_init(fac, D, 2 * d_inner + 2 * N + nheads),
        "conv": causal_conv1d_init(fac, conv_ch, cfg.conv_kernel),
        "A_log": fac.param((nheads,), init="zeros", dtype=torch.float32),
        "D": fac.param((nheads,), init="ones", dtype=torch.float32),
        "dt_bias": fac.param((nheads,), init="zeros", dtype=torch.float32),
        "norm": rmsnorm_init(fac, d_inner),
        "out_proj": dense_init(fac, d_inner, D),
    }


def _mamba2_split(p: Params, u: torch.Tensor, cfg):
    d_inner, nheads, N = _widths(cfg)
    zxbcdt = dense(p["in_proj"], u)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * N, nheads],
                             dim=-1)
    return z, xbc, dt, d_inner, nheads, N


def mamba2_forward(p: Params, u: torch.Tensor, cfg) -> torch.Tensor:
    """u [B, S, D] -> [B, S, D] through the chunked SSD scan."""
    Bsz, S, _ = u.shape
    z, xbc, dt, d_inner, nheads, N = _mamba2_split(p, u, cfg)
    xbc = silu(causal_conv1d(p["conv"], xbc))
    x, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    x = x.reshape(Bsz, S, nheads, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, S, H]
    A = -torch.exp(p["A_log"])  # [H], negative
    log_a = (dt * A).float()  # [B, S, H] log decay per step

    y = _ssd_chunked(x, Bm, Cm, dt, log_a, chunk=min(SSM_CHUNK, S))
    y = y + (p["D"][:, None] * x.float()).to(y.dtype)
    y = y.reshape(Bsz, S, d_inner)
    y = rmsnorm(p["norm"], y * silu(z), cfg.norm_eps)
    return dense(p["out_proj"], y)


def _ssd_chunked(x, Bm, Cm, dt, log_a, *, chunk: int) -> torch.Tensor:
    """SSD scan. x [B, S, H, hd]; Bm, Cm [B, S, N]; dt, log_a [B, S, H] ->
    y [B, S, H, hd] in x's dtype; S % chunk == 0 on both devices. The card
    launches kernel B5 (with this chunk for its backward); the CPU runs the
    reference's chunked einsums."""
    S = x.shape[1]
    assert S % chunk == 0, (S, chunk)
    if x.device.type == "cuda":
        return ops.ssd_scan(x, dt, log_a, Bm, Cm, chunk)
    return ref.ssd_chunked_ref(x, dt, log_a, Bm, Cm, chunk=chunk)


def mamba2_init_state(cfg, batch: int, dtype, device) -> Dict:
    """{"h": [batch, H, hd, N] f32, "conv": [batch, k - 1, conv channels]}
    zeros."""
    d_inner, nheads, N = _widths(cfg)
    return {"h": torch.zeros((batch, nheads, cfg.ssm_head_dim, N),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner + 2 * N),
                                dtype=dtype, device=device)}


def mamba2_step(p: Params, u: torch.Tensor, state: Dict, cfg
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step, u [B, 1, D]. Writes the new "h" and "conv" into
    ``state`` in place and returns (y [B, 1, D], state)."""
    Bsz = u.shape[0]
    z, xbc, dt, d_inner, nheads, N = _mamba2_split(p, u[:, 0, :], cfg)
    xbc, conv_state = causal_conv1d_step(p["conv"], xbc, state["conv"])
    xbc = silu(xbc)
    x, Bm, Cm = torch.split(xbc, [d_inner, N, N], dim=-1)
    x = x.reshape(Bsz, nheads, cfg.ssm_head_dim).float()
    dt = F.softplus(dt.float() + p["dt_bias"])  # [B, H]
    a = torch.exp(dt * -torch.exp(p["A_log"]))  # [B, H]
    h = a[..., None, None] * state["h"] + torch.einsum(
        "bh,bhd,bN->bhdN", dt, x, Bm.float())
    y = torch.einsum("bN,bhdN->bhd", Cm.float(), h)
    y = y + p["D"][:, None] * x
    y = y.reshape(Bsz, 1, d_inner).to(u.dtype)
    y = rmsnorm(p["norm"], y * silu(z[:, None, :]), cfg.norm_eps)
    state["h"].copy_(h)
    state["conv"].copy_(conv_state)
    return dense(p["out_proj"], y), state


# ===========================================================================
# mLSTM (xLSTM matrix-memory block)
# ===========================================================================


def _mlstm_widths(cfg) -> Tuple[int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    H = max(cfg.num_heads, 1)
    return d_inner, H, d_inner // H


def _key_root(hd: int, dtype: torch.dtype) -> float:
    """``jnp.sqrt(hd).astype(dtype)``: the f32 root rounded to the compute
    dtype (bf16 22.625 for sqrt(512)), by which the reference divides k."""
    return float(torch.sqrt(torch.tensor(float(hd))).to(dtype))


def mlstm_init(fac: ParamFactory, cfg) -> Params:
    d_inner, H, _ = _mlstm_widths(cfg)
    D = cfg.d_model
    return {
        "up_proj": dense_init(fac, D, 2 * d_inner),
        "conv": causal_conv1d_init(fac, d_inner, cfg.conv_kernel),
        "wq": dense_init(fac, d_inner, d_inner),
        "wk": dense_init(fac, d_inner, d_inner),
        "wv": dense_init(fac, d_inner, d_inner),
        "w_if": fac.param((d_inner, 2 * H), init="normal"),
        "b_if": fac.param((2 * H,), init="zeros"),
        "norm": rmsnorm_init(fac, d_inner),
        "down_proj": dense_init(fac, d_inner, D),
    }


def _mlstm_gates(p: Params, xc: torch.Tensor, H: int):
    """(log input gate, log forget gate) in f32 from the convolved input."""
    gates = (xc @ p["w_if"].to(xc.dtype) + p["b_if"].to(xc.dtype)).float()
    return gates[..., :H], F.logsigmoid(gates[..., H:])


def mlstm_forward(p: Params, u: torch.Tensor, cfg) -> torch.Tensor:
    """u [B, S, D] -> [B, S, D] through the chunked stabilized mLSTM; S a
    multiple of ``min(SSM_CHUNK, S)``."""
    Bsz, S, _ = u.shape
    d_inner, H, hd = _mlstm_widths(cfg)
    x, z = torch.chunk(dense(p["up_proj"], u), 2, dim=-1)
    xc = silu(causal_conv1d(p["conv"], x))
    q = dense(p["wq"], xc).reshape(Bsz, S, H, hd)
    k = dense(p["wk"], xc).reshape(Bsz, S, H, hd) / _key_root(hd, u.dtype)
    v = dense(p["wv"], x).reshape(Bsz, S, H, hd)
    log_i, log_f = _mlstm_gates(p, xc, H)
    y = _mlstm_chunked(q, k, v, log_i, log_f, chunk=min(SSM_CHUNK, S))
    y = rmsnorm(p["norm"], y.reshape(Bsz, S, d_inner), cfg.norm_eps) * silu(z)
    return dense(p["down_proj"], y)


def _mlstm_chunked(q, k, v, log_i, log_f, *, chunk: int) -> torch.Tensor:
    """Stabilized chunked mLSTM. q/k/v [B, S, H, hd]; gates [B, S, H] f32.

    Quadratic within a chunk under the decay matrix; across chunks the
    matrix state C [B, H, hd, hd] and normalizer n [B, H, hd], carried by a
    loop over chunks. The max stabilizer is folded into each position's
    denominator, bounded below by exp(-m). S % chunk != 0 raises, where
    the reference's reshape fails."""
    Bsz, S, H, hd = q.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the chunk "
                         f"{chunk}")
    n = S // chunk
    qc = q.reshape(Bsz, n, chunk, H, hd).float()
    kc = k.reshape(Bsz, n, chunk, H, hd).float()
    vc = v.reshape(Bsz, n, chunk, H, hd).float()
    lic = log_i.reshape(Bsz, n, chunk, H)
    lfc = log_f.reshape(Bsz, n, chunk, H)

    # decay within a chunk: D[i, j] = exp(sum_{l=j+1..i} log_f + log_i[j])
    Lseg = ref.segsum(lfc.permute(0, 1, 3, 2))  # [B, n, H, c, c]
    logD = Lseg + lic.permute(0, 1, 3, 2)[:, :, :, None, :]
    # stabilizer per query position
    m_intra = torch.where(torch.isfinite(logD), logD, -torch.inf).amax(-1)
    head = torch.cumsum(lfc, dim=2).permute(0, 1, 3, 2)  # decay to chunk start
    m = torch.maximum(m_intra, head)  # also covers the inter-chunk term
    Dmat = torch.exp(logD - m[..., None])
    scores = torch.einsum("bnchd,bnmhd->bnhcm", qc, kc) * Dmat
    y_intra = torch.einsum("bnhcm,bnmhd->bnchd", scores, vc)
    # q_i . sum_j D_ij k_j is the row sum of the decayed scores
    n_intra = scores.sum(dim=-1)  # [B, n, H, c]

    # chunk-final state: C_k = sum_j exp(sum_{l>j} log_f + log_i[j]) k_j v_j^T
    tail = torch.cumsum(lfc, dim=2)
    w = torch.exp(tail[:, :, -1:, :] - tail + lic)  # [B, n, c, H]
    chunk_C = torch.einsum("bnch,bnchd,bnche->bnhde", w, kc, vc)
    chunk_N = torch.einsum("bnch,bnchd->bnhd", w, kc)
    chunk_decay = torch.exp(lfc.sum(dim=2))  # [B, n, H]

    # the states entering each chunk
    C = torch.zeros((Bsz, H, hd, hd), dtype=torch.float32, device=q.device)
    Nrm = torch.zeros((Bsz, H, hd), dtype=torch.float32, device=q.device)
    C_enter, N_enter = [C], [Nrm]
    for j in range(n - 1):
        C = chunk_decay[:, j, :, None, None] * C + chunk_C[:, j]
        Nrm = chunk_decay[:, j, :, None] * Nrm + chunk_N[:, j]
        C_enter.append(C)
        N_enter.append(Nrm)
    C_enter = torch.stack(C_enter, dim=1)  # [B, n, H, hd, hd]
    N_enter = torch.stack(N_enter, dim=1)

    inter_w = torch.exp(head - m)  # [B, n, H, c]
    y_inter = torch.einsum("bnchd,bnhc,bnhde->bnche", qc, inter_w, C_enter)
    n_inter = torch.einsum("bnchd,bnhc,bnhd->bnch", qc, inter_w, N_enter)

    y = y_intra + y_inter
    denom = torch.abs(n_intra.permute(0, 1, 3, 2) + n_inter)  # [B, n, c, H]
    denom = torch.maximum(denom, torch.exp(-m.permute(0, 1, 3, 2)))
    y = y / denom[..., None]
    return y.reshape(Bsz, S, H, hd).to(q.dtype)


def mlstm_init_state(cfg, batch: int, dtype, device) -> Dict:
    """{"C": [batch, H, hd, hd], "n": [batch, H, hd] f32 zeros, "m":
    [batch, H] f32 -inf, "conv": [batch, k - 1, d_inner] zeros}."""
    d_inner, H, hd = _mlstm_widths(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, hd, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H), -torch.inf, **f32),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner),
                                dtype=dtype, device=device)}


def mlstm_step(p: Params, u: torch.Tensor, state: Dict, cfg
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step of the stabilized recurrence, u [B, 1, D]. Writes
    the new "C", "n", "m" and "conv" into ``state`` in place and returns
    (y [B, 1, D], state)."""
    Bsz = u.shape[0]
    d_inner, H, hd = _mlstm_widths(cfg)
    x, z = torch.chunk(dense(p["up_proj"], u[:, 0, :]), 2, dim=-1)
    xc, conv_state = causal_conv1d_step(p["conv"], x, state["conv"])
    xc = silu(xc)
    q = dense(p["wq"], xc).reshape(Bsz, H, hd).float()
    k = (dense(p["wk"], xc).reshape(Bsz, H, hd)
         / _key_root(hd, u.dtype)).float()
    v = dense(p["wv"], x).reshape(Bsz, H, hd).float()
    log_i, log_f = _mlstm_gates(p, xc, H)
    m_new = torch.maximum(log_f + state["m"], log_i)
    i_s = torch.exp(log_i - m_new)
    f_s = torch.exp(log_f + state["m"] - m_new)
    C = f_s[..., None, None] * state["C"] + i_s[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", k, v)
    nrm = f_s[..., None] * state["n"] + i_s[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.maximum(torch.abs(torch.sum(q * nrm, dim=-1)),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(Bsz, 1, d_inner).to(u.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps) * silu(z[:, None, :])
    for key, val in (("C", C), ("n", nrm), ("m", m_new), ("conv", conv_state)):
        state[key].copy_(val)
    return dense(p["down_proj"], y), state


# ===========================================================================
# sLSTM (xLSTM scalar-memory block; strictly sequential recurrence)
# ===========================================================================


def _slstm_widths(cfg) -> Tuple[int, int]:
    H = max(cfg.num_heads, 1)
    return H, cfg.d_model // H


def slstm_init(fac: ParamFactory, cfg) -> Params:
    D = cfg.d_model
    H, hd = _slstm_widths(cfg)
    ff = int(D * 4 / 3 / 64) * 64 or 64  # xLSTM post-up FFN (4/3 factor)
    return {
        "conv": causal_conv1d_init(fac, D, cfg.conv_kernel),
        "w": fac.param((D, 4 * D), init="normal"),
        "r": fac.param((H, hd, 4 * hd), init="normal", fan_in=hd),
        "b": fac.param((4 * D,), init="zeros"),
        "norm": rmsnorm_init(fac, D),
        "ff_up": dense_init(fac, D, ff),
        "ff_down": dense_init(fac, ff, D),
    }


def _slstm_cell(p: Params, wx_t: torch.Tensor, state, H: int, hd: int):
    """One time step. wx_t [B, 4D] f32 is the precomputed input term; the
    pre-activations interleave z, i, f, o per unit ([B, H, hd, 4])."""
    c, nrm, h, m = state
    Bsz = wx_t.shape[0]
    rh = torch.einsum("bhd,hde->bhe", h, p["r"].float()).reshape(
        Bsz, 4 * H * hd)
    zi, ii, fi, oi = (wx_t + rh).reshape(Bsz, H, hd, 4).unbind(-1)
    log_f = F.logsigmoid(fi)
    m_new = torch.maximum(log_f + m, ii)
    i_s = torch.exp(ii - m_new)
    f_s = torch.exp(log_f + m - m_new)
    c_new = f_s * c + i_s * torch.tanh(zi)
    n_new = f_s * nrm + i_s
    h_new = torch.sigmoid(oi) * c_new / torch.clamp(n_new, min=1e-6)
    return (c_new, n_new, h_new, m_new), h_new


def _slstm_input(p: Params, xc: torch.Tensor) -> torch.Tensor:
    return (xc @ p["w"].to(xc.dtype) + p["b"].to(xc.dtype)).float()


def _slstm_out(p: Params, h: torch.Tensor, dtype, cfg) -> torch.Tensor:
    y = rmsnorm(p["norm"], h.to(dtype), cfg.norm_eps)
    return dense(p["ff_down"], gelu(dense(p["ff_up"], y)))


def slstm_forward(p: Params, u: torch.Tensor, cfg) -> torch.Tensor:
    """u [B, S, D] -> [B, S, D]: S cells in a loop, from c = n = h = 0 and
    m = -inf."""
    Bsz, S, D = u.shape
    H, hd = _slstm_widths(cfg)
    wx = _slstm_input(p, silu(causal_conv1d(p["conv"], u)))
    pf = dict(p, r=p["r"].float())  # cast once, not once a step
    z0 = torch.zeros((Bsz, H, hd), dtype=torch.float32, device=u.device)
    state = (z0, z0, z0, torch.full_like(z0, -torch.inf))
    hs = []
    for t in range(S):
        state, h_t = _slstm_cell(pf, wx[:, t], state, H, hd)
        hs.append(h_t)
    return _slstm_out(p, torch.stack(hs, dim=1).reshape(Bsz, S, D), u.dtype,
                      cfg)


def slstm_init_state(cfg, batch: int, dtype, device) -> Dict:
    """{"c", "n", "h": [batch, H, hd] f32 zeros, "m": f32 -inf, "conv":
    [batch, k - 1, D] zeros}."""
    H, hd = _slstm_widths(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, hd), **f32),
            "n": torch.zeros((batch, H, hd), **f32),
            "h": torch.zeros((batch, H, hd), **f32),
            "m": torch.full((batch, H, hd), -torch.inf, **f32),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_model),
                                dtype=dtype, device=device)}


def slstm_step(p: Params, u: torch.Tensor, state: Dict, cfg
               ) -> Tuple[torch.Tensor, Dict]:
    """One decode step, u [B, 1, D]. Writes the new "c", "n", "h", "m" and
    "conv" into ``state`` in place and returns (y [B, 1, D], state)."""
    Bsz = u.shape[0]
    H, hd = _slstm_widths(cfg)
    xc, conv_state = causal_conv1d_step(p["conv"], u[:, 0, :], state["conv"])
    wx = _slstm_input(p, silu(xc))
    (c, nrm, h, m), h_out = _slstm_cell(
        p, wx, (state["c"], state["n"], state["h"], state["m"]), H, hd)
    y = _slstm_out(p, h_out.reshape(Bsz, 1, cfg.d_model), u.dtype, cfg)
    for key, val in (("c", c), ("n", nrm), ("h", h), ("m", m),
                     ("conv", conv_state)):
        state[key].copy_(val)
    return y, state
