"""Wrapper of the CUDA flash-decode (``csrc/decode_attention.cu``); it
replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:decode_attention``.

The wrapper takes CUDA tensors only, checks them, allocates the output and
the split workspace with ``torch.empty``, launches both kernels (the split
pass and the merge) on the current stream and raises if the launch returns
a CUDA error. It never falls back to the plain version: ``kernels/ops.py``
picks the plain version for CPU tensors, and only for them.

The reference zero-pads a ragged cache up to its ``block_k`` and walks the
kv blocks of each (row, q head) in order. Here the cache is split into
``splits`` ranges of rows that run in parallel and are merged by a
log-sum-exp rescale; rows at or past ``length`` are never read, so there
is no padding. ``splits`` depends only on the shapes and the card's SM
count, never on ``length``, which stays on the device: no launch waits for
the host.

``launches`` counts the calls that launched the kernel in this process; a
run that sets it to 0 and reads it afterwards shows whether decode
attention ran here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build

HEAD_DIMS = (16, 32, 64, 80, 112, 128)
MAX_GROUP = 8        # q heads one block serves (csrc: kMaxGroup)
SPLIT_ALIGN = 64     # a split's rows are a multiple of this
BLOCKS_PER_SM = 4    # aim: this many split blocks for every SM
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.decode_attention_error_string)
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(B: int, S: int, Hq: int, Hkv: int, sms: int
         ) -> Tuple[int, int, int, int]:
    """(gc, n_chunks, chunk_rows, splits): a block serves ``gc`` q heads
    (the group size rounded up to a power of two, at most ``MAX_GROUP``),
    ``n_chunks`` blocks cover one kv head's group, and the S allocated rows
    are cut into ``splits`` ranges of ``chunk_rows`` so that the grid holds
    about ``BLOCKS_PER_SM`` blocks per SM, none shorter than
    ``SPLIT_ALIGN`` rows."""
    g = Hq // Hkv
    gc = min(MAX_GROUP, 1 << (g - 1).bit_length())
    n_chunks = -(-g // gc)
    want = -(-BLOCKS_PER_SM * sms // (B * Hkv * n_chunks))
    splits = max(1, min(want, -(-S // SPLIT_ALIGN)))
    rows = -(-S // splits)
    chunk_rows = -(-rows // SPLIT_ALIGN) * SPLIT_ALIGN
    return gc, n_chunks, chunk_rows, -(-S // chunk_rows)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be bfloat16 or all float32; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32, got {length.dtype}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be [B, Hq, d] and k, v [B, S, Hkv, d]; got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Hq, d = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != d:
        raise ValueError(f"k and v must be [B={B}, S, Hkv, d={d}]; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if length.shape != (B,):
        raise ValueError(f"length must be [B={B}], got {tuple(length.shape)}")
    if k.shape[1] == 0:
        raise ValueError("the cache holds no rows (S = 0)")
    if k.shape[2] == 0 or Hq % k.shape[2]:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads "
                         f"{k.shape[2]}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must be at most 65535 (grid)")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over the first ``length[b]`` cached rows
    of each batch row b, on the card. q [B, Hq, d], k and v [B, S, Hkv, d]
    with Hq % Hkv == 0, all bfloat16 or all float32, and ``length`` [B]
    int32, contiguous on one CUDA device -> [B, Hq, d] in q's dtype; rows
    with ``length == 0`` are zeros."""
    global launches
    _check(q, k, v, length)
    B, Hq, d = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    gc, n_chunks, chunk_rows, splits = plan(
        B, S, Hq, Hkv, _sm_count(q.device.index or 0))
    n = B * Hq * splits  # one partial (m, l, acc[d]) per (row, q head, split)
    ws = torch.empty(n * (d + 2), dtype=torch.float32, device=q.device)
    ws_m, ws_l, ws_acc = ws[:n], ws[n:2 * n], ws[2 * n:]
    fn, err_str = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                 out.data_ptr(), ws_m.data_ptr(), ws_l.data_ptr(),
                 ws_acc.data_ptr(), B, S, Hq, Hkv, d, gc, n_chunks,
                 chunk_rows, splits, d ** -0.5,
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return out
