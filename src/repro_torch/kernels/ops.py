"""Dispatch for the port's kernels (counterpart of ``repro/kernels/ops.py``).

A CUDA tensor goes to the kernel, which launches or raises. A CPU tensor
takes the kernel's plain version in ``kernels/ref.py``, and that is the
only case in which a forward runs the plain version. Flash attention's
backward is autograd through its plain version on either device, and the
SSD scan's autograd through its chunked plain form: the reference has no
backward kernel either.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import block_perturb
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref, sparse_agg
from repro_torch.kernels import ssm_scan
from repro_torch.models.module import tree_leaves


def sparse_cohort_add(idx: torch.Tensor, vals: torch.Tensor,
                      weights: torch.Tensor, length: int) -> torch.Tensor:
    """Dense [length] f32 fold of K clients' top-k (idx, vals) rows, the
    compressed-uplink Eq. 1 aggregation (``kernels/sparse_agg.py``)."""
    if idx.device.type == "cpu":
        return ref.sparse_cohort_add_ref(idx, vals, weights, length)
    return sparse_agg.sparse_cohort_add(idx, vals, weights, length)


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, ``flash_attention_ref`` on CPU
    tensors. Backward: autograd through ``flash_attention_ref`` on the saved
    inputs, the reference's recompute contract (its custom_vjp backward
    differentiates the XLA oracle); there is no backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        if q.device.type == "cpu":
            return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
        return fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = ref.flash_attention_ref(q, k, v, causal=ctx.causal,
                                          scale=ctx.scale)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Differentiable flash attention, q [B, S, Hq, d], k/v [B, S, Hkv, d]
    (``kernels/flash_attention.py``)."""
    return _FlashAttention.apply(q, k, v, causal, scale)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """One-token GQA attention over a KV cache, q [B, Hq, d], k/v
    [B, S, Hkv, d], length [B] int32 (``kernels/decode_attention.py``).
    Forward only, as the reference's: it has no VJP."""
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, length)
    return dec.decode_attention(q, k, v, length)


class _SSDScan(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the sequential ``ssd_scan_ref``
    on CPU tensors. Backward: autograd through ``ssd_chunked_ref`` (the
    reference model's ``_ssd_chunked``, the function the reference
    differentiates) on the saved inputs, with ``chunk`` rows a chunk; there
    is no backward kernel. The sequential form is never differentiated: at
    the training shape its graph would hold an f32 [B, H, hd, N] state for
    every token, about 7.5 GB a layer."""

    @staticmethod
    def forward(ctx, x, dt, log_a, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, log_a, Bm, Cm)
        ctx.chunk = chunk
        if x.device.type == "cpu":
            return ref.ssd_scan_ref(x, dt, log_a, Bm, Cm)
        return ssm_scan.ssd_scan(x.contiguous(), dt.contiguous(),
                                 log_a.contiguous(), Bm.contiguous(),
                                 Cm.contiguous())

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = ref.ssd_chunked_ref(*inputs, chunk=ctx.chunk)
        grads = torch.autograd.grad(out, inputs, g)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """Differentiable SSD scan, x [B, S, H, hd], dt and log_a [B, S, H] f32,
    Bm and Cm [B, S, N] -> y [B, S, H, hd] (``kernels/ssm_scan.py``).
    ``chunk`` is the backward's chunk length (S % chunk == 0). The forward
    is the same function for any chunk."""
    return _SSDScan.apply(x, dt, log_a, Bm, Cm, chunk)


def diff_sqnorm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum((a - b)^2)`` as a 0-dim float64 tensor on a's device: the
    difference of the f32-widened operands in f32, its square and sum in
    f64 (``kernels/block_perturb.py``; the pace controller's Eq. 2 norms).
    It does not wait for the card."""
    if a.device.type == "cpu":
        return ref.diff_sqnorm_ref(a, b)
    return block_perturb.diff_sqnorm_f64(a, b)


def update_sqnorm(tree_new, tree_old) -> torch.Tensor:
    """The on-device half of the pace controller, ``||new - old||^2`` over
    every leaf, as the reference's f32 scalar: each leaf's f64 sum by
    ``diff_sqnorm``, added in f64 in leaf order, rounded once."""
    parts = [diff_sqnorm(x, y)
             for x, y in zip(tree_leaves(tree_new), tree_leaves(tree_old))]
    return torch.stack(parts).sum().float()
