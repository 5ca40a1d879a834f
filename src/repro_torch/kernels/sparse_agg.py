"""Wrapper of the CUDA sparse cohort scatter-add (``csrc/sparse_agg.cu``),
the compressed-uplink Eq. 1 fold; it replaces the Pallas TPU kernel
``repro/kernels/sparse_agg.py:sparse_cohort_add_fwd``.

The wrapper takes CUDA tensors only, checks them, zeroes the output with
``torch.zeros`` on the current stream, launches the kernel there and raises
if the launch returns a CUDA error. It never falls back to the plain
version: ``kernels/ops.py`` picks the plain version for CPU tensors, and
only for them.

The reference keeps the dense output resident in TPU VMEM and so sends
leaves above ``MAX_VMEM_ELEMS = 2**21`` elements to the XLA scatter. The
card has no such residency limit: every leaf length goes through this
kernel, including ResNet-18's 3x3 512->512 convs (2,359,296 elements).

``launches`` counts the launches of this kernel in the process; a run
that sets it to 0 and reads it afterwards shows whether the fold ran here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("sparse_agg")
        fn = lib.sparse_cohort_add_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.sparse_cohort_add_error_string.argtypes = [ctypes.c_int]
        lib.sparse_cohort_add_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.sparse_cohort_add_error_string)
    return _fn


def _check(idx: torch.Tensor, vals: torch.Tensor, weights: torch.Tensor,
           length: int) -> None:
    for name, t, dtype in (("idx", idx, torch.int32), ("vals", vals, torch.float32),
                           ("weights", weights, torch.float32)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != idx.device:
            raise ValueError(f"{name} is on {t.device}, idx on {idx.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if idx.dim() != 2 or vals.shape != idx.shape:
        raise ValueError(f"idx and vals must both be [K, k]; got "
                         f"{tuple(idx.shape)} and {tuple(vals.shape)}")
    if weights.shape != (idx.shape[0],):
        raise ValueError(f"weights must be [K={idx.shape[0]}], got "
                         f"{tuple(weights.shape)}")
    if not 0 < length <= 2 ** 31:
        raise ValueError(f"length {length} outside (0, 2**31] (int32 indices)")


def sparse_cohort_add(idx: torch.Tensor, vals: torch.Tensor,
                      weights: torch.Tensor, length: int) -> torch.Tensor:
    """Dense [length] f32 ``sum_i weights[i] * scatter(idx[i], vals[i])``
    on the card. idx [K, k] int32, vals [K, k] f32, weights [K] f32, all
    contiguous on one CUDA device."""
    global launches
    length = int(length)
    _check(idx, vals, weights, length)
    out = torch.zeros(length, dtype=torch.float32, device=idx.device)
    if idx.numel() == 0:
        return out
    fn, err_str = _launcher()
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx.data_ptr(), vals.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), idx.numel(), idx.shape[1], length, stream)
    if err != 0:
        raise RuntimeError(f"sparse_cohort_add launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return out
