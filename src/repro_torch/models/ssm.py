"""State-space layers (counterpart of ``repro/models/ssm.py``): Mamba2
(SSD).

The full-sequence forward runs the chunked SSD scan (quadratic within a
chunk, recurrent across chunks), so no S x S matrix is ever held; decode
is the O(1)-state one-step recurrence. All recurrence math is f32 with
log-space decay.

On the card every ``_ssd_chunked`` call goes through the scan kernel
(``kernels/ops.py:ssd_scan``, kernel B5), whose backward is autograd
through the same chunked form; on the CPU it runs the reference's chunked
einsums (``kernels/ref.py:ssd_chunked_ref``). One decode step writes the
layer's state in place, as the attention decode writes its KV cache.

xLSTM's mLSTM and sLSTM are not ported: their functions raise.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_init,
                                       causal_conv1d_step, dense, dense_init,
                                       rmsnorm, rmsnorm_init, silu)
from repro_torch.models.module import ParamFactory, Params

SSM_CHUNK = 256
_XLSTM = "xLSTM (mLSTM, sLSTM) is not ported (ROADMAP A15, xLSTM)"


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


def _xlstm(*args, **kwargs):
    raise NotImplementedError(_XLSTM)


mlstm_init = mlstm_forward = mlstm_init_state = mlstm_step = _xlstm
slstm_init = slstm_forward = slstm_init_state = slstm_step = _xlstm
