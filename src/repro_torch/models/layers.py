"""Layer primitives (counterpart of ``repro/models/layers.py``): dense,
the LM's norms, activations and RoPE, Mamba2's causal conv1d, and the
CNN's conv and batchnorm.

Norms compute in float32 and cast back to the input dtype, and RoPE
rotates in float32, as the reference does; a bfloat16 model rounds at the
same places.

Public tensors are NHWC and conv weights are stored HWIO, as in the
reference. ``x.permute(0, 3, 1, 2)`` of an NHWC tensor is an NCHW view in
PyTorch's channels-last memory format, so ``F.conv2d`` takes it without a
copy and hands back channels-last output, which permutes back to NHWC.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.module import ParamFactory, Params


def dense_init(fac: ParamFactory, d_in: int, d_out: int, *, bias: bool = False,
               scale: float = 1.0) -> Params:
    p = {"w": fac.param((d_in, d_out), init="normal", scale=scale)}
    if bias:
        p["b"] = fac.param((d_out,), init="zeros")
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def rmsnorm_init(fac: ParamFactory, d: int) -> Params:
    return {"scale": fac.param((d,), init="ones")}


def rmsnorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(fac: ParamFactory, d: int) -> Params:
    return {"scale": fac.param((d,), init="ones"),
            "bias": fac.param((d,), init="zeros")}


def layernorm(p: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def norm_init(fac: ParamFactory, d: int, kind: str) -> Params:
    return layernorm_init(fac, d) if kind == "layernorm" else rmsnorm_init(fac, d)


def norm(p: Params, x: torch.Tensor, kind: str, eps: float = 1e-5
         ) -> torch.Tensor:
    return layernorm(p, x, eps) if kind == "layernorm" else rmsnorm(p, x, eps)


def activation(name: str):
    """``jax.nn``'s activations; its gelu is the tanh approximation
    (``gelu``). Its silu is ``F.silu``, one rounding, which the dense MLPs
    take. The layers whose bf16 output left the reference's own bf16-f32
    spread with it take ``silu``, in the reference's roundings, instead:
    the Mamba2 and xLSTM blocks' convolutions and gates (``models/ssm.py``)
    and the MoE FFNs' experts and shared experts (``models/moe.py``)."""
    return {"silu": F.silu, "relu": F.relu, "gelu": gelu}[name]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (the tanh approximation) with the reference's
    roundings: sqrt(2 / pi) and 0.044715 rounded to x's dtype first, x^3 as
    x (x x), every op in x's dtype. ``F.gelu`` computes in f32 with the
    exact constant and rounds once: in bf16 it differs in more than half of
    an sLSTM block's FFN outputs."""
    c = float(torch.tensor(math.sqrt(2 / math.pi)).to(x.dtype))
    k = float(torch.tensor(0.044715).to(x.dtype))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x))))))


class _Silu(torch.autograd.Function):
    """Forward: x * 1 / (1 + exp(-x)), each op in x's dtype, as XLA rounds
    ``jax.nn.silu``. Backward: g * s (1 + x (1 - s)) with s = sigmoid(x),
    the exact derivative. Autograd through the forward's ops would give
    0 * inf = NaN where exp(-x) overflows (x < -88)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x * (1 / (1 + torch.exp(-x)))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(x)
        return g * (s * (1 + x * (1 - s)))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` with the reference's roundings (``_Silu``).
    ``F.silu`` rounds once and differs by one ulp in about a third of bf16
    outputs; through Mamba2's gates that grows to 0.06 at a layer's output,
    against 0.002 with these roundings."""
    return _Silu.apply(x)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape [head_dim // 2], float32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. Rotates the
    two halves of the head dim in float32 and casts back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def causal_conv1d_init(fac: ParamFactory, channels: int, k: int) -> Params:
    return {"w": fac.param((k, channels), init="normal", fan_in=k),
            "b": fac.param((channels,), init="zeros")}


def causal_conv1d(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, x [batch, seq, channels]: k shifted
    adds in x's dtype over a left-padded input, as the reference writes
    it."""
    k = p["w"].shape[0]
    w = p["w"].to(x.dtype)  # [k, C]
    pad = F.pad(x, (0, 0, k - 1, 0))
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + pad[:, i:i + x.shape[1], :] * w[i]
    return y + p["b"].to(x.dtype)


def causal_conv1d_step(p: Params, x_t: torch.Tensor, conv_state: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step, x_t [batch, C], conv_state [batch, k - 1, C]:
    (y [batch, C], the new state, the window's last k - 1 rows)."""
    w = p["w"].to(x_t.dtype)
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)  # [b, k, C]
    y = torch.einsum("bkc,kc->bc", window, w) + p["b"].to(x_t.dtype)
    return y, window[:, 1:, :]


def conv2d_init(fac: ParamFactory, c_in: int, c_out: int, k: int, *,
                bias: bool = True) -> Params:
    p = {"w": fac.param((k, k, c_in, c_out), init="normal",
                        fan_in=k * k * c_in, scale=1.414)}
    if bias:
        p["b"] = fac.param((c_out,), init="zeros")
    return p


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding: output ceil(size / stride), the odd pad going
    AFTER. A 3x3 stride-2 conv on an even input pads (0, 1), where
    ``F.conv2d(padding=1)`` would pad (1, 1) and shift the output."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Params, x: torch.Tensor, stride: int = 1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC conv with an HWIO weight, padded as XLA pads."""
    w = p["w"].to(x.dtype)
    xc = x.permute(0, 3, 1, 2)
    if padding == "SAME":
        top, bottom = _same_pads(x.shape[1], w.shape[0], stride)
        left, right = _same_pads(x.shape[2], w.shape[1], stride)
        if top or bottom or left or right:
            xc = F.pad(xc, (left, right, top, bottom))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride)
    y = y.permute(0, 2, 3, 1)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def batchnorm_init(fac: ParamFactory, c: int) -> Tuple[Params, Params]:
    params = {"scale": fac.param((c,), init="ones"),
              "bias": fac.param((c,), init="zeros")}
    state = {"mean": torch.zeros(c, device=fac.device),
             "var": torch.ones(c, device=fac.device)}
    return params, state


def batchnorm(p: Params, s: Params, x: torch.Tensor, *, train: bool,
              momentum: float = 0.9, eps: float = 1e-5):
    """BatchNorm over all but the channel axis, written out as the
    reference writes it: the BIASED batch variance normalises in train mode
    and feeds the running update ``m * old + (1 - m) * batch``.
    ``F.batch_norm`` differs on both counts (unbiased running variance,
    momentum ``1 - m``). Running stats carry no gradient."""
    xf = x.float()
    if train:
        dims = tuple(range(x.dim() - 1))
        mean = xf.mean(dim=dims)
        var = xf.var(dim=dims, correction=0)
        new_s = {"mean": momentum * s["mean"] + (1 - momentum) * mean.detach(),
                 "var": momentum * s["var"] + (1 - momentum) * var.detach()}
    else:
        mean, var = s["mean"], s["var"]
        new_s = s
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype), new_s
