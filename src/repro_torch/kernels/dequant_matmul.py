"""Wrapper of the CUDA dequantizing GEMM (``csrc/dequant_matmul.cu``), the
int8 cache tier's leading product; it replaces the Pallas TPU kernel
``repro/kernels/dequant_matmul.py:dequant_matmul_fwd``.

``dequant_matmul(q, scale, w, out_dtype)`` is
``(q.float() * scale) @ w.float()`` accumulated in f32 and written in
``out_dtype``, without the f32 copy of q ever existing in device memory.
q [M, K] is int8, f32 or bf16; w [K, N] f32 or bf16; the scale f32 in any
layout ``ref.normalize_scale`` takes; out f32 or bf16. Any M, K, N >= 1:
tails are masked in the kernel, nothing is padded.

The wrapper takes CUDA tensors only, checks them, allocates the output and
the split-K workspace with ``torch.empty``, launches on the current stream
and raises if the launch returns a CUDA error. It never falls back to the
plain version: ``kernels/ops.py`` picks the plain version for CPU tensors,
and only for them.

``launches`` counts the calls that launched the kernel in this process; a
run that sets it to 0 and reads it afterwards shows whether the product
ran here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import normalize_scale

Q_DTYPES = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}
W_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SCALE_KINDS = {"row": 0, "col": 1, "full": 2}
BM, BN, BK = 32, 64, 32      # csrc: kBM, kBN, kBK
BLOCKS_PER_SM = 4
MIN_STEPS_PER_SPLIT = 4      # k steps of BK a slice holds at least
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("dequant_matmul")
        fn = lib.dequant_matmul_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.dequant_matmul_error_string.argtypes = [ctypes.c_int]
        lib.dequant_matmul_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.dequant_matmul_error_string)
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """``(splits, k_per_split)``: K cut into slices of whole BK steps so
    that the grid holds about ``BLOCKS_PER_SM`` blocks per SM, each slice at
    least ``MIN_STEPS_PER_SPLIT`` steps deep. It depends on the shape and
    the SM count only, so a repeated call sums in the same order."""
    tiles = -(-M // BM) * -(-N // BN)
    steps = -(-K // BK)
    want = -(-BLOCKS_PER_SM * sms // tiles)
    splits = max(1, min(want, steps // MIN_STEPS_PER_SPLIT))
    per = -(-steps // splits)
    return -(-steps // per), per * BK


def _check(q: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    for name, t, dtypes in (("q", q, Q_DTYPES), ("scale", scale,
                                                 (torch.float32,)),
                            ("w", w, W_DTYPES)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} must be one of {list(dtypes)}, got "
                            f"{t.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    if q.dim() != 2 or w.dim() != 2 or q.shape[1] != w.shape[0]:
        raise ValueError(f"q {tuple(q.shape)} and w {tuple(w.shape)} do not "
                         "make a [M, K] @ [K, N] product")
    if -(-q.shape[0] // BM) > 65535:
        raise ValueError(f"M = {q.shape[0]} exceeds the grid's "
                         f"{65535 * BM} rows")


def dequant_matmul(q: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q.float() * scale) @ w.float()`` on the card, f32 accumulation,
    [M, N] in ``out_dtype``."""
    global launches
    _check(q, scale, w, out_dtype)
    M, K = q.shape
    N = w.shape[1]
    kind, s = normalize_scale(scale, M, K)
    q, s, w = q.contiguous(), s.contiguous(), w.contiguous()
    if M == 0 or N == 0 or K == 0:
        return torch.zeros(M, N, dtype=out_dtype, device=q.device)
    splits, k_per_split = plan(M, N, K, _sm_count(q.device.index))
    out = torch.empty(M, N, dtype=out_dtype, device=q.device)
    ws = (out if splits == 1 and out_dtype == torch.float32 else
          torch.empty(splits * M * N, dtype=torch.float32, device=q.device))
    fn, err_str = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), Q_DTYPES[q.dtype], s.data_ptr(),
                 SCALE_KINDS[kind], w.data_ptr(), W_DTYPES[w.dtype],
                 ws.data_ptr(), out.data_ptr(), OUT_DTYPES[out_dtype], M, N,
                 K, splits, k_per_split, stream)
    if err != 0:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    launches += 1
    return out
