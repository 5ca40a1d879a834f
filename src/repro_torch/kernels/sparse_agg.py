"""Wrapper of the CUDA sparse cohort scatter-add (``csrc/sparse_agg.cu``),
the compressed-uplink Eq. 1 fold; it replaces the Pallas TPU kernel
``repro/kernels/sparse_agg.py:sparse_cohort_add_fwd``.

The kernel sums in the reference's order (client ascending, then entry
ascending, each product and each add rounded once), so its result equals
the plain version run on the CPU (``kernels/ref.py``) bit for bit, and a
rerun gives the same bits. It needs every row of idx non-decreasing, as
top-k sends it; see ``sparse_cohort_add`` for the two routes.

The wrapper takes CUDA tensors only, checks them, allocates the output with
``torch.empty`` (the kernel writes every element), launches the kernel on
the current stream and raises if the launch returns a CUDA error. It never
falls back to the plain version: ``kernels/ops.py`` picks the plain version
for CPU tensors, and only for them.

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
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.sparse_cohort_add_error_string.argtypes = [ctypes.c_int]
        lib.sparse_cohort_add_error_string.restype = ctypes.c_char_p
        lib.sparse_cohort_add_max_clients.restype = ctypes.c_int
        _fn = (fn, lib.sparse_cohort_add_error_string,
               lib.sparse_cohort_add_max_clients())
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
    if idx.numel() >= 2 ** 31:
        raise ValueError(f"K * k = {idx.numel()} entries; at most 2**31 - 1")


def sparse_cohort_add(idx: torch.Tensor, vals: torch.Tensor,
                      weights: torch.Tensor, length: int, *,
                      sorted_rows: bool = False) -> torch.Tensor:
    """Dense [length] f32 ``sum_i weights[i] * scatter(idx[i], vals[i])``
    on the card, in the reference's order. idx [K, k] int32, vals [K, k]
    f32, weights [K] f32, all contiguous on one CUDA device; duplicate
    indices accumulate in entry order.

    Two routes, each one launch of the kernel:

    * ``sorted_rows=True``: the caller promises that every row of idx is
      non-decreasing (top-k's ascending indices). Nothing runs but the
      kernel. The kernel checks the promise and that every index lies in
      [0, length); a broken one fails the launch with a device-side assert,
      which the next synchronizing call raises (the CUDA context is then
      lost, as after PyTorch's own device-side index asserts). It never
      returns a wrong sum.
    * ``sorted_rows=False`` (the default, any rows): the wrapper first
      sorts each row stably (``torch.sort(stable=True)``) and permutes vals
      alongside, so duplicates keep their entry order and the sum is the
      same. That adds a segmented sort of the K x k indices (int64 order
      out) and a gather of vals, a few launches that move about K*k*32
      bytes, four times the kernel's own reads.
    """
    global launches
    length = int(length)
    _check(idx, vals, weights, length)
    K, k = idx.shape
    if idx.numel() == 0:
        return torch.zeros(length, dtype=torch.float32, device=idx.device)
    fn, err_str, max_clients = _launcher()
    if K > max_clients:
        raise ValueError(f"K = {K} clients; one launch takes at most "
                         f"{max_clients}")
    if not sorted_rows:
        idx, order = torch.sort(idx, dim=1, stable=True)
        vals = torch.gather(vals, 1, order)
    out = torch.empty(length, dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(idx.data_ptr(), vals.data_ptr(), weights.data_ptr(),
                 out.data_ptr(), K, k, length, stream)
    if err != 0:
        raise RuntimeError(f"sparse_cohort_add launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return out
