"""Wrapper of the CUDA flash attention forward (``csrc/flash_attention.cu``);
it replaces the Pallas TPU kernel
``repro/kernels/flash_attention.py:flash_attention_fwd``.

The wrapper takes CUDA tensors only, checks them, allocates the output with
``torch.empty``, launches the kernel on the current stream and raises if
the launch returns an error. It never falls back to the plain version:
``kernels/ops.py`` picks the plain version for CPU tensors, and only for
them.

The reference zero-pads a ragged sequence up to its block sizes and runs
one grid step per (q block, kv block). Here the kv blocks are a loop inside
a block that ends at the causal limit, fed by a ring of tiles that the
Tensor Memory Accelerator fills with zeros past the sequence and past the
head dim, and the masks stay on the scores, so there is no padded copy and
no block-size argument. A block serves the q heads of one kv head
together (``plan``), so the group stages each K and V tile once.

``launches`` counts the launches of this kernel in the process; a run
that sets it to 0 and reads it afterwards shows whether attention ran here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_DIM = 256            # dk and dv at most (csrc: kMaxDim)
MMA_ROWS = 16            # query rows of one warp (kMmaRows)
WARPS = (8, 4)           # warps of a block, most first (csrc: kMaxWarps)
MAX_HEADS = 8            # q heads a block serves at most (kMaxHeads)
MAX_STAGES = 4           # ring depth at most (kMaxStages)
KV_ROWS = {2: 64, 4: 32}  # kv rows of a ring slot by item size (kKvBf16/F32)
SWIZZLE_COLS = 64        # bf16 columns of one swizzled region
REGION_BYTES = 64 * 128  # one bf16 region of a slot: 64 kv rows x 128 bytes
CEILINGS = {2: (64, 96, 128, 256), 4: (64, 128, 256)}  # register ceilings
SMEM_PER_BLOCK = 232448  # 227 KB, one block's most on Hopper (kMaxSmem)
ALIGN_SLACK = 1024       # the swizzle's period, before the ring
MAX_GRID_Y = 65535
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("flash_attention")
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_attention_error_string)
    return _fn


def library_smem_bytes(dk: int, dv: int, itemsize: int, warps: int,
                       stages: int) -> int:
    """Shared memory of one block as the built library computes it, to
    hold ``smem_bytes`` against on the card."""
    return _build.load("flash_attention").flash_attention_smem_bytes(
        dk, dv, itemsize, warps, stages)


class Plan(NamedTuple):
    rows: int        # query rows of a block: warps x 16 = positions x heads
    heads: int       # q heads of one kv head that a block serves
    n_chunks: int    # blocks that cover one kv head's group
    warps: int       # warps of a block, 16 query rows each
    positions: int   # query positions of a block
    kv_rows: int     # kv rows of a ring slot
    stages: int      # ring depth
    ceiling: int     # register ceiling, columns
    smem: int        # shared memory bytes of one block
    grid: Tuple[int, int]  # (B * Hkv * n_chunks, position tiles)


def check_head_dims(dk: int, dv: int, itemsize: int) -> None:
    """Raise ``ValueError`` naming the width unless ``dk`` and ``dv`` are
    each a whole number of 16-byte vectors (8 bf16 or 4 f32 values) and at
    most ``MAX_DIM``."""
    vec = 16 // itemsize
    for name, d in (("q/k", dk), ("v", dv)):
        if d < vec or d > MAX_DIM or d % vec:
            raise ValueError(
                f"head dim {d} of {name} must be a multiple of {vec} (one "
                f"16-byte vector of {itemsize}-byte values) from {vec} to "
                f"{MAX_DIM}")


def ceiling(dk: int, dv: int, itemsize: int) -> int:
    """The register ceiling (csrc: ``ceiling``): the least of
    ``CEILINGS[itemsize]`` that holds both widths."""
    d = max(dk, dv)
    return next(c for c in CEILINGS[itemsize] if c >= d)


def q_pitch(dk: int, ceil: int, itemsize: int) -> int:
    """Bytes of one query row in shared memory (csrc: ``q_pitch``). bf16:
    the ceiling's columns in an odd number of 16-byte units (ldmatrix's 8
    rows hit 8 bank groups); f32: dk in a number of units that is 2 mod 4
    (a quarter warp reads 4 rows x 2 vectors)."""
    if itemsize == 2:
        return 16 * ((ceil * 2 // 16) | 1)
    units = dk * 4 // 16
    return 16 * (units + (6 - units % 4) % 4)


def slot_bytes(dk: int, dv: int, itemsize: int) -> int:
    """Bytes of one ring slot (csrc: ``slot_bytes``): bf16 the register
    ceiling's 64-column regions of 64 kv rows x 128 bytes, K's then V's
    (columns past a width arrive as zeros); f32 32 dense rows of each."""
    if itemsize == 2:
        regions = -(-ceiling(dk, dv, itemsize) // SWIZZLE_COLS)
        return 2 * regions * REGION_BYTES
    return KV_ROWS[4] * (dk + dv) * 4


def smem_bytes(dk: int, dv: int, itemsize: int, warps: int,
               stages: int) -> int:
    """Shared memory of one block (csrc: ``smem_bytes``): alignment slack,
    the ring, every warp's 16 q rows, a barrier and a counter a slot."""
    ceil = ceiling(dk, dv, itemsize)
    return (ALIGN_SLACK + stages * slot_bytes(dk, dv, itemsize)
            + warps * MMA_ROWS * q_pitch(dk, ceil, itemsize) + 16 * stages)


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, Hq: int, Hkv: int, dk: int, dv: int,
         itemsize: int) -> Plan:
    """A block holds ``warps`` x 16 query rows: ``heads`` q heads of one
    kv head (the largest power of two that divides both the group and
    ``warps``, at most ``MAX_HEADS``) times ``positions`` positions, so
    each staged K/V tile feeds every row and the group stages it once;
    ``n_chunks`` blocks cover a group. The most warps of ``WARPS`` for
    which two ring slots and the warps' q rows fit a block (8, but 4 for
    f32 past the 128 ceiling). The ring is as deep as fits, at most
    ``MAX_STAGES``."""
    g = Hq // Hkv
    ceil = ceiling(dk, dv, itemsize)
    for warps in WARPS:
        fixed = smem_bytes(dk, dv, itemsize, warps, 0)
        stages = min(MAX_STAGES, (SMEM_PER_BLOCK - fixed)
                     // (slot_bytes(dk, dv, itemsize) + 16))
        if stages >= 2:
            break
    heads = 1
    while (heads * 2 <= MAX_HEADS and warps % (heads * 2) == 0
           and g % (heads * 2) == 0):
        heads *= 2
    positions = warps * MMA_ROWS // heads
    n_chunks = g // heads
    return Plan(warps * MMA_ROWS, heads, n_chunks, warps, positions,
                KV_ROWS[itemsize], stages, ceil,
                smem_bytes(dk, dv, itemsize, warps, stages),
                (B * Hkv * n_chunks, -(-S // positions)))


def block_rows(p: Plan, B: int, S: int, Hq: int, Hkv: int
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(batch row, q head, position) of every query row of every block, as
    the kernel assigns them (csrc: ``locate``): grid x is (batch row, kv
    head, head chunk), grid y the position tiles in reverse, warp w takes
    head w / (warps / heads) and 16 consecutive positions; rows past S
    exist and are never stored. Arrays of shape [grid x, grid y, warps,
    16]."""
    g = Hq // Hkv
    gx, gy = p.grid
    bx = np.arange(gx)[:, None, None, None]
    by = np.arange(gy)[None, :, None, None]
    w = np.arange(p.warps)[None, None, :, None]
    r = np.arange(MMA_ROWS)[None, None, None, :]
    b = bx // (Hkv * p.n_chunks)
    hk = (bx // p.n_chunks) % Hkv
    chunk = bx % p.n_chunks
    groups = p.warps // p.heads
    h = hk * g + chunk * p.heads + w // groups
    pos = (gy - 1 - by) * p.positions + (w % groups) * MMA_ROWS + r
    shape = (gx, gy, p.warps, MMA_ROWS)
    return (np.broadcast_to(b, shape), np.broadcast_to(h, shape),
            np.broadcast_to(pos, shape))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [B, S, H, d], got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be bfloat16 or all float32; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    B, S, Hq, dk = q.shape
    if k.shape[:2] != (B, S) or k.shape[3] != dk or \
            v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k must be [B={B}, S={S}, Hkv, dk={dk}] and v "
                         f"[B, S, Hkv, dv]; got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    Hkv = k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads {Hkv}")
    check_head_dims(dk, v.shape[3], q.element_size())
    p = plan(B, S, Hq, Hkv, dk, v.shape[3], q.element_size())
    # grid limits, and the tensor maps' coordinates (int32 rows, up to one
    # slot past S) and batch stride (below 2^40 bytes)
    if p.grid[0] >= 2 ** 31 or p.grid[1] > MAX_GRID_Y:
        raise ValueError(f"B={B}, Hkv={Hkv}, S={S} give a grid {p.grid} past "
                         f"the launch limits (2^31 - 1, {MAX_GRID_Y})")
    if S + max(KV_ROWS.values()) >= 2 ** 31:
        raise ValueError(f"S={S} past the TMA's int32 row coordinate")
    if S * Hkv * max(dk, v.shape[3]) * q.element_size() >= 2 ** 40:
        raise ValueError("a batch row of k or v spans 2^40 bytes or more "
                         "(TMA stride)")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """softmax(scale * q k^T) v on the card. q [B, S, Hq, dk], k [B, S,
    Hkv, dk] and v [B, S, Hkv, dv] with Hq % Hkv == 0, all bfloat16 or all
    float32, dk and dv whole 16-byte vectors up to 256, contiguous on one
    CUDA device -> [B, S, Hq, dv] in q's dtype; the default scale is
    dk^-0.5."""
    global launches
    _check(q, k, v)
    B, S, Hq, dk = q.shape
    Hkv, dv = k.shape[2], v.shape[3]
    scale = dk ** -0.5 if scale is None else float(scale)
    out = torch.empty((B, S, Hq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    p = plan(B, S, Hq, Hkv, dk, dv, q.element_size())
    fn, err_str = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, Hq, Hkv, dk, dv, p.heads, p.n_chunks, p.warps,
                 p.stages, scale, int(bool(causal)),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return out
