"""Wrapper of the CUDA block-perturbation reduction
(``csrc/block_perturb.cu``), the pace controller's Eq. 2 norms; it replaces
the Pallas TPU kernel ``repro/kernels/block_perturb.py:diff_sqnorm``.

``diff_sqnorm_f64(a, b)`` is ``sum((a - b)^2)`` over two flat buffers of
equal length, each operand f32 or bf16 and widened to f32 on its own, the
difference taken in f32 and squared and summed in f64; it returns an f64
scalar tensor on the card without waiting for it. The pace controller
reads this one. ``diff_sqnorm`` and ``tree_diff_sqnorm`` keep the
reference's signatures and return its f32 scalar.

The wrapper takes CUDA tensors only, checks them, allocates the output and
the per-block partials with ``torch.empty``, launches both kernels (the
partial sums and the fixed-order final sum) on the current stream and
raises if the launch returns a CUDA error. It never falls back to the
plain version: ``kernels/ops.py`` picks the plain version for CPU tensors,
and only for them. Operands need not be 16-byte aligned (a view at a
leaf's offset inside a flat snapshot is not); the source peels an
unaligned head.

``launches`` counts the calls that launched the kernel in this process; a
run that sets it to 0 and reads it afterwards shows whether the norms ran
here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.models.module import tree_leaves

DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256        # csrc: kThreads
ELEMS_PER_THREAD = 16  # csrc: kChunk * kUnroll, one iteration's elements
BLOCKS_PER_SM = 4
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("block_perturb")
        fn = lib.diff_sqnorm_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.diff_sqnorm_error_string.argtypes = [ctypes.c_int]
        lib.diff_sqnorm_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.diff_sqnorm_error_string)
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan(n: int, sms: int) -> int:
    """Blocks of the partial-sum grid: enough that every thread has at least
    one iteration's elements, at most ``BLOCKS_PER_SM`` per SM. It depends
    on n and the SM count only, so a repeated call sums in the same order."""
    want = -(-n // (THREADS * ELEMS_PER_THREAD))
    return max(1, min(want, BLOCKS_PER_SM * sms))


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.device != b.device:
        raise ValueError(f"a is on {a.device}, b on {b.device}")
    if a.numel() != b.numel():
        raise ValueError(f"a and b must have as many elements; got "
                         f"{a.numel()} and {b.numel()}")


def diff_sqnorm_f64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum((a - b)^2)`` as a 0-dim f64 tensor on a's card, the difference
    of the f32-widened operands taken in f32 and its square summed in f64.
    a and b: as many elements each, f32 or bf16 (each on its own),
    contiguous, on one CUDA device; any shapes."""
    global launches
    _check(a, b)
    n = a.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float64, device=a.device)
    blocks = plan(n, _sm_count(a.device.index))
    ws = torch.empty(blocks + 1, dtype=torch.float64, device=a.device)
    out = ws[blocks]
    fn, err_str = _launcher()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), int(a.dtype == torch.bfloat16), b.data_ptr(),
                 int(b.dtype == torch.bfloat16), n, blocks, ws.data_ptr(),
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"diff_sqnorm launch failed: CUDA error {err} "
                           f"({err_str(err).decode()})")
    launches += 1
    return out


def diff_sqnorm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``sum((a - b)^2)`` as the reference's f32 scalar (the f64 sum,
    rounded once)."""
    return diff_sqnorm_f64(a, b).float()


def tree_diff_sqnorm(tree_a, tree_b) -> torch.Tensor:
    """Sum over leaves of ``||a - b||^2`` as an f32 scalar: each leaf's f64
    sum from the kernel, added in f64 in leaf order, rounded once."""
    parts = [diff_sqnorm_f64(x, y)
             for x, y in zip(tree_leaves(tree_a), tree_leaves(tree_b))]
    return torch.stack(parts).sum().float()
