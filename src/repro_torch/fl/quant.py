"""Precision tiers of the frozen-prefix feature cache, and bf16 local
training (counterpart of ``repro/fl/quant.py``).

  tier "f32"   4 bytes an element, exact;
  tier "fp16"  2 bytes an element, a plain narrowing;
  tier "int8"  1 byte an element plus f32 scales: per (sample, channel)
               symmetric quantization, q = clip(round(x / s), -127, 127),
               s = amax / 127 over each sample's interior axes per channel
               ([N, H, W, C] features store scales [N, 1, 1, C]; flattened
               [N, D] features one scale a row, [N, 1]).

Encoded features are tensors on the cache's device. The cached consumer's
loss decodes them (``make_tiered_loss``): int8 dequantizes in f32, fp16
upcasts. A quant-aware consumer (``loss_fn.consumes_quantized``) instead
receives int8 values and their scales and routes its leading product
through ``tiered_matmul``, the dequantizing GEMM of
``kernels/ops.py:dequant_matmul``: the CUDA kernel for tensors on the card,
its plain version for tensors on the CPU.

``make_input_cast_loss`` and ``cast_floating`` are the bf16 half:
``fl/engine.py:make_fused_round(compute_dtype=...)`` trains on a bf16 copy
of the params while the master params, the optimizer state and the Eq. 1
fold stay f32. The admission ladder that picks a client's tier lives with
the memory model (``core/memory_model.py:cache_tier_ladder``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.memory_model import CACHE_TIERS
from repro_torch.kernels import ops
from repro_torch.models.module import tree_map


def normalize_tier(tier) -> Optional[str]:
    """A cache-plan entry in canonical form: ``True`` is the f32 tier (the
    boolean plans of servers before tiers), a false value no cache."""
    if tier is None or tier is False or (isinstance(tier, np.bool_)
                                         and not tier):
        return None
    if tier is True or isinstance(tier, np.bool_):
        return "f32"
    if tier in CACHE_TIERS:
        return str(tier)
    raise ValueError(f"unknown cache tier {tier!r}; expected one of "
                     f"{CACHE_TIERS} (or True/False)")


def _group_axes(ndim: int) -> Tuple[int, ...]:
    """Axes reduced per quantization group: the interior axes of a >= 3-D
    array (per sample and channel), axis 1 of a 2-D one (per sample)."""
    if ndim < 2:
        raise ValueError(f"feature arrays must be >=2-D, got ndim={ndim}")
    return tuple(range(1, ndim - 1)) if ndim >= 3 else (1,)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (sample, channel) symmetric int8: ``(q int8, scale f32)`` with
    the scale keeping the reduced axes as size-1 dims, so
    ``q.float() * scale`` broadcasts back and both index alike along the
    sample axis. The reference's steps: amax / 127 in f32, scale 1.0 where
    amax is 0, ``torch.round`` (half to even, as ``jnp.round``), clip to
    [-127, 127]. XLA folds the division by the constant 127 into a product
    with its f32 reciprocal, so the scale here is that product too: the
    reference's scales bit for bit."""
    xf = x.float()
    amax = torch.amax(xf.abs(), dim=_group_axes(x.dim()), keepdim=True)
    inv127 = torch.tensor(1.0 / 127.0, dtype=torch.float32, device=x.device)
    scale = torch.where(amax > 0, amax * inv127, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize_int8``, in f32."""
    return q.float() * scale


class EncodedFeatures(NamedTuple):
    """One client's cached prefix features at a tier, on the cache's
    device."""
    tier: str
    values: torch.Tensor                  # f32 | f16 | int8, sample-leading
    scale: Optional[torch.Tensor] = None  # int8 only: f32, broadcastable

    @property
    def nbytes(self) -> int:
        """Stored bytes: the values at their dtype, plus int8's scales."""
        n = self.values.numel() * self.values.element_size()
        if self.scale is not None:
            n += self.scale.numel() * self.scale.element_size()
        return n


def encode_features(x: torch.Tensor, tier: str) -> EncodedFeatures:
    """Quantize on write: features leave the frozen prefix once and are
    stored at the admitted tier, on x's device.

    >>> x = torch.linspace(-1.0, 1.0, 8).reshape(2, 4)
    >>> [encode_features(x, t).nbytes for t in CACHE_TIERS]  # f32 fp16 int8
    [32, 16, 16]
    """
    if tier == "f32":
        return EncodedFeatures("f32", x.float().contiguous())
    if tier == "fp16":
        return EncodedFeatures("fp16", x.to(torch.float16).contiguous())
    if tier == "int8":
        q, s = quantize_int8(x)
        return EncodedFeatures("int8", q, s)
    raise ValueError(f"unknown cache tier {tier!r}")


def decode_features(enc: EncodedFeatures) -> torch.Tensor:
    """The f32 features an encoding stands for (tests; the training path
    decodes inside the loss, ``make_tiered_loss``)."""
    if enc.tier == "int8":
        return dequantize_int8(enc.values, enc.scale)
    return enc.values.float()


def feature_batch_arrays(enc: EncodedFeatures) -> Dict[str, torch.Tensor]:
    """The data entries a cached client contributes: ``x`` at the stored
    dtype, plus ``x_scale`` for int8. Both are sample-leading, so a round
    gathers them by one minibatch index plan."""
    out = {"x": enc.values}
    if enc.scale is not None:
        out["x_scale"] = enc.scale
    return out


def tiered_matmul(x: torch.Tensor, x_scale: Optional[torch.Tensor],
                  w: torch.Tensor) -> torch.Tensor:
    """The leading product of a quant-aware cached consumer,
    ``dequant(x) @ w`` in f32: x [N, D] int8 (or float) features, x_scale
    broadcastable scales ([N, 1] from the 2-D quantizer, or None for the
    float tiers), w [D, H]. The dequantizing GEMM runs where x lives: the
    CUDA kernel on the card, the plain version on the CPU. Differentiable
    in w and x_scale."""
    if x_scale is None:
        x_scale = torch.ones((), dtype=torch.float32, device=x.device)
    return ops.dequant_matmul(x, x_scale, w)


def make_tiered_loss(loss_fn, tier: Optional[str],
                     compute_dtype: Optional[str] = None):
    """Wrap a cached consumer's loss so that its batch carries encoded
    features:

    * int8 with ``loss_fn.consumes_quantized``: the batch keeps ``x`` int8
      and ``x_scale``, for the consumer's ``tiered_matmul``;
    * int8 otherwise: dequantize in f32 (the scales never drop to bf16),
      then cast to the compute dtype, and drop ``x_scale``;
    * fp16: upcast to the compute dtype (f32 without one);
    * f32 or None: the loss itself.
    """
    tier = normalize_tier(tier)
    if tier in (None, "f32"):
        return loss_fn
    if tier == "int8" and getattr(loss_fn, "consumes_quantized", False):
        def quant_aware(params, frozen, state, batch):
            return loss_fn(params, frozen, state, dict(batch))
        quant_aware.consumes_quantized = True
        return quant_aware
    out_dt = getattr(torch, compute_dtype) if compute_dtype else torch.float32

    def tiered(params, frozen, state, batch):
        b = dict(batch)
        if tier == "int8":
            b["x"] = (b["x"].float() * b.pop("x_scale").float()).to(out_dt)
        else:
            b["x"] = b["x"].to(out_dt)
        return loss_fn(params, frozen, state, b)

    return tiered


def make_input_cast_loss(loss_fn, compute_dtype: Optional[str]):
    """Cast the batch's floating entries to ``compute_dtype`` before the
    loss, except the ``*_scale`` keys: quantization scales stay f32, so
    int8 dequantization is never done in bf16."""
    if compute_dtype is None:
        return loss_fn
    dt = getattr(torch, compute_dtype)

    def cast(params, frozen, state, batch):
        b = {k: (v.to(dt) if v.is_floating_point() and not k.endswith("_scale")
                 else v) for k, v in batch.items()}
        return loss_fn(params, frozen, state, b)

    return cast


def cast_floating(tree, dtype):
    """A tree with its floating leaves cast to ``dtype`` (given as a name
    or a ``torch.dtype``); other leaves pass through."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return tree_map(lambda x: x.to(dt) if x.is_floating_point() else x, tree)
