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

``launches`` counts the launches of this kernel in the process; a run that
sets it to 0 and reads it afterwards shows whether the scan ran here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# (head dim, state size) pairs the kernel is built for: Zamba2-7B's 64/64,
# the reduced configs' 16/16, the reference's kernel sweep's (8|16, 4|16)
WIDTHS = ((64, 64), (16, 16), (16, 4), (8, 16), (8, 4))
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("ssm_scan")
        fn = lib.ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ssd_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssd_scan_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.ssd_scan_error_string)
    return _fn


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
    if (hd, Bm.shape[2]) not in WIDTHS:
        raise ValueError(f"(head dim, state) = ({hd}, {Bm.shape[2]}) not in "
                         f"{WIDTHS}")
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535 (grid)")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, log_a: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence ``h_t = exp(log_a_t) h_{t-1} + dt_t x_t B_t^T,
    y_t = h_t C_t`` on the card. x [B, S, H, hd] with Bm, Cm [B, S, N], all
    bfloat16 or all float32; dt and log_a [B, S, H] float32; all contiguous
    on one CUDA device -> y [B, S, H, hd] in x's dtype, f32 inside."""
    global launches
    _check(x, dt, log_a, Bm, Cm)
    B, S, H, hd = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn, err_str = _launcher()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), log_a.data_ptr(), Bm.data_ptr(),
                 Cm.data_ptr(), y.data_ptr(), B, S, H, hd, Bm.shape[2],
                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    launches += 1
    return y
