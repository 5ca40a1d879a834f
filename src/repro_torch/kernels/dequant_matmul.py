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
and raises if the launch returns a CUDA error. Split K's per-tile counters
are one zeroed buffer per device, which every launch leaves zeroed; calls
on one device are meant for one stream at a time. A 0-d, ``(1,)`` or
``(1, 1)`` scale goes to the kernel as a row scale of stride 0, so its
products take the one-term route. It never falls back to the
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
# the tile classes, block_m: (BN, BK) (csrc: Tile<BM>): rows of M a block
# owns, columns of N, the depth of a k step
TILES = {32: (64, 64), 64: (64, 64), 128: (128, 32)}
# the 128-row class chains every product through one accumulator (for
# registers); below this K, where a chain's truncations would weigh more
# than f32's roundings, M > 64 takes the 64-row class instead
CHAIN_MIN_K = 256
MAX_EXTENT = 1 << 22         # K and N at most (csrc: kMaxExtent)
MIN_STEPS_PER_SPLIT = 4      # k steps a slice holds at least
launches = 0
_fn = None
_counters = {}               # device index -> int32 per-tile counters, all 0


def _bind(lib: ctypes.CDLL):
    """(launch, error string) of a built ``csrc/dequant_matmul.cu``."""
    fn = lib.dequant_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.dequant_matmul_error_string.argtypes = [ctypes.c_int]
    lib.dequant_matmul_error_string.restype = ctypes.c_char_p
    return fn, lib.dequant_matmul_error_string


def _launcher():
    global _fn
    if _fn is None:
        _fn = _bind(_build.load("dequant_matmul"))
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def block_m(M: int, K: int) -> int:
    """The tile class of an [M, K] @ [K, N] product: the rows of M one block
    owns."""
    if M <= 32:
        return 32
    return 64 if M <= 64 or K < CHAIN_MIN_K else 128


def plan(M: int, N: int, K: int, sms: int) -> Tuple[int, int]:
    """``(splits, k_per_split)``: K cut into slices of whole BK steps of
    M's tile class, slice z covering ``[z k_per_split, (z + 1)
    k_per_split)``, so that the grid holds about one block per SM, each
    slice at least ``MIN_STEPS_PER_SPLIT`` steps deep and none empty. It
    depends on the shape and the SM count only, so a repeated call sums in
    the same order."""
    bm = block_m(M, K)
    bn, bk = TILES[bm]
    tiles = -(-M // bm) * -(-N // bn)
    steps = -(-K // bk)
    splits = max(1, min(sms // tiles, steps // MIN_STEPS_PER_SPLIT))
    per = -(-steps // splits)
    return -(-steps // per), per * bk


def _counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device``, all 0: the kernel's
    last block of a tile sets its counter back to 0, so one buffer serves
    every call on the device's stream."""
    buf = _counters.get(device.index)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[device.index] = buf
    return buf


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
    M, K = q.shape
    if -(-M // block_m(M, K)) > 65535:
        raise ValueError(f"M = {M} exceeds the grid's 65,535 row tiles")
    if K > MAX_EXTENT or w.shape[1] > MAX_EXTENT:
        raise ValueError(f"K = {K} and N = {w.shape[1]} must be at most "
                         f"{MAX_EXTENT}")


def dequant_matmul(q: torch.Tensor, scale: torch.Tensor, w: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(q.float() * scale) @ w.float()`` on the card, f32 accumulation,
    [M, N] in ``out_dtype``."""
    global launches
    _check(q, scale, w, out_dtype)
    M, K = q.shape
    N = w.shape[1]
    kind, s = normalize_scale(scale, M, K)
    s_stride = 1
    if scale.numel() == 1:  # 0-d, (1,) or (1, 1): one row scale for all
        kind, s, s_stride = "row", scale.reshape(1), 0
    if M == 0 or N == 0 or K == 0:
        return torch.zeros(M, N, dtype=out_dtype, device=q.device)
    out = _launch(_launcher(), q, s, kind, s_stride, w, out_dtype,
                  plan(M, N, K, _sm_count(q.device.index)))
    launches += 1
    return out


def _launch(bound, q: torch.Tensor, s: torch.Tensor, kind: str,
            s_stride: int, w: torch.Tensor, out_dtype: torch.dtype,
            split_plan: Tuple[int, int]) -> torch.Tensor:
    """One launch of ``bound`` (``_bind``'s pair) on checked operands, K cut
    by ``split_plan``; the output, or a raise on a CUDA error."""
    q, s, w = q.contiguous(), s.contiguous(), w.contiguous()
    (M, K), N = q.shape, w.shape[1]
    bm = block_m(M, K)
    splits, k_per_split = split_plan
    out = torch.empty(M, N, dtype=out_dtype, device=q.device)
    ws = counters = None
    if splits > 1:
        tiles = -(-M // bm) * -(-N // TILES[bm][0])
        ws = torch.empty(splits * tiles * bm * TILES[bm][0],
                         dtype=torch.float32, device=q.device)
        counters = _counter_buffer(q.device, tiles)
    fn, err_str = bound
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), Q_DTYPES[q.dtype], s.data_ptr(),
                 SCALE_KINDS[kind], s_stride, w.data_ptr(), W_DTYPES[w.dtype],
                 None if ws is None else ws.data_ptr(),
                 None if counters is None else counters.data_ptr(),
                 out.data_ptr(), OUT_DTYPES[out_dtype], M, N, K, bm, splits,
                 k_per_split, stream)
    if err != 0:
        raise RuntimeError(f"dequant_matmul launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    return out
