"""Wrapper of the CUDA flash attention forward (``csrc/flash_attention.cu``);
it replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention_fwd``.

The wrapper takes CUDA tensors only, checks them, allocates the output with
``torch.empty``, launches the kernel on the current stream and raises if
the launch returns a CUDA error. It never falls back to the plain version:
``kernels/ops.py`` picks the plain version for CPU tensors, and only for
them.

The reference zero-pads a ragged sequence up to its block sizes and runs
one grid step per (q block, kv block). Here a ragged tail is masked inside
the kernel by bounds, and the kv blocks are a loop that ends at the causal
limit, so there is no padding and no block-size argument.

``launches`` counts the launches of this kernel in the process; a run
that sets it to 0 and reads it afterwards shows whether attention ran here.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 112, 128)
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"q, k and v must all be bfloat16 or all float32; "
                            f"got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, d], got {tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    B, S, Hq, d = q.shape
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != d:
        raise ValueError(f"k and v must be [B={B}, S={S}, Hkv, d={d}]; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if k.shape[2] == 0 or Hq % k.shape[2]:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads "
                         f"{k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must be at most 65535 (grid)")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(scale * q k^T) v on the card. q [B, S, Hq, d], k and v
    [B, S, Hkv, d] with Hq % Hkv == 0, all bfloat16 or all float32,
    contiguous on one CUDA device -> [B, S, Hq, d] in q's dtype."""
    global launches
    _check(q, k, v)
    B, S, Hq, d = q.shape
    scale = d ** -0.5 if scale is None else float(scale)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn, err_str = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, Hq, k.shape[2], d, scale, int(bool(causal)),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return out
