"""Wrapper of the CUDA chunked SSD scan (``csrc/ssm_scan.cu``); it replaces
the Pallas TPU kernel ``repro/kernels/ssm_scan.py:ssd_scan``.

The wrapper takes CUDA tensors only, checks them, allocates the output with
``torch.empty``, launches the kernel on the current stream and raises if
the launch returns a CUDA error. It never falls back to a plain version:
``kernels/ops.py`` picks the plain version for CPU tensors, and only for
them.

The reference requires S to be a multiple of its chunk and runs one grid
step per (b, h, chunk). Here one block walks the chunks of one (b, h) in
order and masks a ragged last chunk by bounds, so any S works and there is
no chunk argument: the kernel's own 64-row chunk gives the same function.
The head dim and the state size are run-time widths from 1 to
``MAX_WIDTH`` (``check_widths``); the kernel is built for ceiling classes
of each (``plan``).

``launches`` counts the launches of this kernel in the process; a run that
sets it to 0 and reads it afterwards shows whether the scan ran here.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_WIDTH = 128          # head dim and state size at most (csrc: kMaxWidth)
CHUNK = 64               # rows of a chunk (kChunk)
# ceiling classes of each width by item size (csrc: width_class, f32_class)
CLASSES = {2: (64, 128), 4: (16, 64, 128)}
SMEM_PER_BLOCK = 232448  # 227 KB, one block's most on Hopper (kMaxSmem)
F32_THREADS = 256        # threads of an f32 block (kThreadsF32)
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("ssm_scan")
        fn = lib.ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.ssd_scan_error_string)
    return _fn


def check_widths(hd: int, N: int, dtype: torch.dtype) -> None:
    """Raise ``ValueError`` naming the width unless the head dim ``hd`` and
    the state size ``N`` are each from 1 to ``MAX_WIDTH``; ``TypeError``
    unless ``dtype`` (that of x, Bm and Cm) is bfloat16 or float32. Any
    such pair runs in both dtypes."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x, Bm and Cm must be bfloat16 or float32, got "
                        f"{dtype}")
    for name, w in (("head dim", hd), ("state size", N)):
        if not 1 <= w <= MAX_WIDTH:
            raise ValueError(f"{name} {w} must be from 1 to {MAX_WIDTH}")


def width_class(w: int, itemsize: int) -> int:
    """The ceiling class of a width for the kernel of this item size."""
    return next(c for c in CLASSES[itemsize] if c >= w)


def pitch(cols: int) -> int:
    """Bytes of one bf16 row of ``cols`` columns in shared memory (csrc:
    ``pitch``): an odd number of 16-byte units, so that ldmatrix's 8 rows
    at one column hit 8 bank groups."""
    return 16 * ((cols * 2 // 16) | 1)


class Plan(NamedTuple):
    hd_class: int      # ceiling class of the head dim
    n_class: int       # ceiling class of the state size
    warps: int         # warps of a block (one block per head and batch row)
    plane_buffers: int  # buffers of the state's three bf16 terms (bf16)
    smem: int          # shared memory bytes of one block


def plan(hd: int, N: int, itemsize: int) -> Plan:
    """How the kernel runs at these widths, computed as the source computes
    it. bf16: 4 warps at the (64, 64) class, else 8; a double-buffered ring
    of chunk tiles (x [64][hd class], B and C [64][N class] at ``pitch``,
    dt and log_a [64] f32), the state's three bf16 terms [N class][hd
    class] in two buffers where they fit, else one, and each warp's cum
    and w [64] f32. f32: 256 threads; x, B, B^T, C^T, S^T, h^T and three
    [64] vectors in f32."""
    hc, nc = width_class(hd, itemsize), width_class(N, itemsize)
    if itemsize == 4:
        smem = 4 * (CHUNK * hc + 3 * CHUNK * nc + CHUNK * CHUNK + nc * hc
                    + 3 * CHUNK)
        return Plan(hc, nc, F32_THREADS // 32, 0, smem)
    warps = 4 if hc == nc == 64 else 8
    stage = CHUNK * (pitch(hc) + 2 * pitch(nc)) + 2 * CHUNK * 4
    planes = 3 * nc * pitch(hc)
    scratch = warps * 2 * CHUNK * 4
    buffers = 2 if 2 * stage + 2 * planes + scratch <= SMEM_PER_BLOCK else 1
    return Plan(hc, nc, warps, buffers, 2 * stage + buffers * planes + scratch)


def library_smem_bytes(hd: int, N: int, itemsize: int) -> int:
    """Shared memory of one block as the built library computes it, to
    hold ``plan`` against on the card."""
    return _build.load("ssm_scan").ssd_scan_smem_bytes(hd, N,
                                                       int(itemsize == 2))


def _check(x, dt, log_a, Bm, Cm) -> None:
    for name, t in (("x", x), ("dt", dt), ("log_a", log_a), ("Bm", Bm),
                    ("Cm", Cm)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in (torch.bfloat16, torch.float32) or \
            Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"x, Bm and Cm must all be bfloat16 or all float32; "
                        f"got {x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or log_a.dtype != torch.float32:
        raise TypeError(f"dt and log_a must be float32; got {dt.dtype}, "
                        f"{log_a.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be [B, S, H, hd], got {tuple(x.shape)}")
    B, S, H, hd = x.shape
    if dt.shape != (B, S, H) or log_a.shape != (B, S, H):
        raise ValueError(f"dt and log_a must be [B={B}, S={S}, H={H}]; got "
                         f"{tuple(dt.shape)} and {tuple(log_a.shape)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm and Cm must be [B={B}, S={S}, N]; got "
                         f"{tuple(Bm.shape)} and {tuple(Cm.shape)}")
    check_widths(hd, Bm.shape[2], x.dtype)
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535 (grid)")


def _vectors(width: int, *tensors) -> int:
    """1 where rows of ``width`` bf16 values are whole 16-byte vectors and
    every tensor starts on 16 bytes, so the kernel copies them by vector."""
    return int(width % 8 == 0 and all(t.data_ptr() % 16 == 0
                                      for t in tensors))


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence ``h_t = exp(log_a_t) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t`` on the card. x [B, S, H, hd] with Bm, Cm [B, S, N], all
    bfloat16 or all float32, hd and N from 1 to ``MAX_WIDTH``; dt and log_a
    [B, S, H] float32; all contiguous on one CUDA device -> y [B, S, H, hd]
    in x's dtype, f32 inside."""
    global launches
    _check(x, dt, log_a, Bm, Cm)
    B, S, H, hd = x.shape
    N = Bm.shape[2]
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn, err_str = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), log_a.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), B, S, H, hd, N,
                 int(x.dtype == torch.bfloat16), _vectors(hd, x),
                 _vectors(N, Bm, Cm), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    launches += 1
    return y
