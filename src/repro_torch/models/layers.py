"""CNN layer primitives (counterpart of the conv / batchnorm / dense parts
of ``repro/models/layers.py``).

Public tensors are NHWC and conv weights are stored HWIO, as in the
reference. ``x.permute(0, 3, 1, 2)`` of an NHWC tensor is an NCHW view in
PyTorch's channels-last memory format, so ``F.conv2d`` takes it without a
copy and hands back channels-last output, which permutes back to NHWC.
"""
from __future__ import annotations

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
