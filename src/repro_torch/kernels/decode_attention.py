"""Wrapper of the CUDA flash-decode (``csrc/decode_attention.cu``); it
replaces the Pallas TPU kernel
``repro/kernels/decode_attention.py:decode_attention``.

The wrapper takes CUDA tensors only, checks them, allocates the output with
``torch.empty``, launches the one kernel on the current stream and raises
if the launch returns an error. It never falls back to the plain version:
``kernels/ops.py`` picks the plain version for CPU tensors, and only for
them.

The reference zero-pads a ragged cache up to its ``block_k`` and walks the
kv blocks of each (row, q head) in order. Here the cache is split into
``splits`` ranges of rows that run in parallel as the blocks of one thread
block cluster and are merged on chip by a log-sum-exp rescale; rows at or
past ``length`` are never used, so there is no padding. The plan depends
only on the shapes and the card's SM count, never on ``length``, which
stays on the device: no launch waits for the host.

``launches`` counts the calls that launched the kernel in this process; a
run that sets it to 0 and reads it afterwards shows whether decode
attention ran here.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_DIM = 256            # dk and dv at most (csrc: kMaxDim)
MAX_GROUP = 8            # q heads one block serves (csrc: kMaxGroup)
MAX_CLUSTER = 16         # splits of one cluster; above 8 non-portable
MAX_STAGES = 8           # ring depth at most (csrc: kMaxStages)
MAX_ROWS = 256           # cached rows of one ring stage at most
BOX_ROWS = 16            # cached rows of one TMA box (csrc: kBoxRows)
SWIZZLE_COLS = 64        # bf16: columns of one swizzled TMA box
CONSUMER_WARPS = 4       # csrc: kConsumerWarps
UNROLL = 4               # f32: rows a lane group takes per step (kUnroll)
MMA_ROWS = 16            # bf16: cached rows of one warp step (kMmaRows)
STAGE_BYTES = 32768      # bf16: aim for about this many bytes a stage
SPLIT_ALIGN = 16         # a split's allocated rows are a multiple of this
SPLIT_ROWS = 2048        # a long cache is cut into splits of at most this
BLOCKS_PER_SM = 3        # blocks resident on every SM (csrc: launch bounds)
SMEM_PER_SM = 233472     # 228 KB of shared memory on each Hopper SM
SMEM_PER_BLOCK = 232448  # 227 KB, one block's most
SMEM_RESERVED = 1024     # the system's share of each resident block
launches = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.decode_attention_error_string)
    return _fn


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class Plan(NamedTuple):
    gc: int          # q heads a block serves
    n_chunks: int    # blocks that cover one kv head's group
    chunk_rows: int  # allocated rows of one split at most
    splits: int      # splits of one (row, kv head, head chunk): the cluster
    rows: int        # cached rows of one ring stage
    stages: int      # ring depth
    smem: int        # shared memory bytes of one block


def lane_width(dk: int, dv: int, itemsize: int) -> int:
    """f32: lanes of one lane group (csrc: L), a power of two that covers
    a row of either width, one 16-byte vector a lane, two past 32."""
    vec = 16 // itemsize
    nvk, nvv = dk // vec, dv // vec
    per_lane = 1 if max(nvk, nvv) <= 32 else 2
    need = max(-(-nvk // per_lane), -(-nvv // per_lane))
    return 1 << (need - 1).bit_length()


def pitch_bytes(d: int, itemsize: int) -> int:
    """Bytes of one cached row in a ring stage (csrc: ``row_layout``).
    bf16: 128 bytes for each 64 columns (a region the TMA writes
    swizzled), and the rest of the row padded to an odd number of 16-byte
    units, so that 8 consecutive rows start in 8 bank groups; f32: the row
    as it is."""
    if itemsize == 4:
        return d * 4
    rem = d % SWIZZLE_COLS
    units = rem * itemsize // 16 + 1
    pad = 16 * (units if units % 2 else units + 1) if rem else 0
    return d // SWIZZLE_COLS * 128 + pad


def smem_bytes(dk: int, dv: int, itemsize: int, gc: int, rows: int,
               stages: int, splits: int) -> int:
    """Shared memory of one block (csrc: ``smem_bytes``): 1024 bytes of
    alignment slack (the swizzle's period); the ring of ``stages`` K and V
    tiles, which after the stream holds the consumer warps' partials; the
    inbox, where the cluster's blocks push the (m, l) of every split and
    head and the accumulators of this block's slice of the outputs; two
    mbarriers a stage."""
    def round8(n):
        return -(-n // 8) * 8
    tiles = stages * rows * (pitch_bytes(dk, itemsize)
                             + pitch_bytes(dv, itemsize))
    scratch = CONSUMER_WARPS * gc * (dv + 2) * 4
    inbox = (splits * -(-gc * dv // splits) + 2 * splits * gc) * 4
    return 1024 + round8(max(tiles, scratch)) + round8(inbox) + 16 * stages


@functools.lru_cache(maxsize=None)
def plan(B: int, S: int, Hq: int, Hkv: int, dk: int, dv: int, itemsize: int,
         sms: int, max_splits: int = MAX_CLUSTER) -> Plan:
    """A block serves ``gc`` q heads (the group size rounded up to a power
    of two, at most ``MAX_GROUP``), and ``n_chunks`` blocks cover one kv
    head's group. Each group's cache is shared by ``splits`` blocks, one
    cluster (at most ``max_splits``, itself at most ``MAX_CLUSTER``): as
    many as one wave of ``BLOCKS_PER_SM`` blocks an SM holds, and more for
    a long cache, so that no split covers more than ``SPLIT_ROWS``
    allocated rows (on the card the splits share ``[0, length)`` evenly,
    so a long row keeps all its blocks busy beside short ones). A split
    covers at most ``chunk_rows`` allocated rows, a multiple of
    ``SPLIT_ALIGN``. A ring stage holds ``rows`` cached rows (at most
    ``MAX_ROWS``): in bf16 whole 16-row steps of every consumer warp, about
    ``STAGE_BYTES``; in f32 one step of every lane group of the block. The
    ring is as deep as ``BLOCKS_PER_SM`` blocks an SM allow (a grid of
    fewer blocks than SMs: one), but two stages at least where a block can
    hold them, at most ``MAX_STAGES`` and no deeper than one split's
    tiles."""
    g = Hq // Hkv
    gc = min(MAX_GROUP, 1 << (g - 1).bit_length())
    n_chunks = -(-g // gc)
    groups = B * Hkv * n_chunks
    one_wave = max(1, BLOCKS_PER_SM * sms // groups)
    splits = min(max(one_wave, -(-S // SPLIT_ROWS)), max_splits, MAX_CLUSTER,
                 -(-S // SPLIT_ALIGN))
    chunk_rows = -(-(-(-S // splits)) // SPLIT_ALIGN) * SPLIT_ALIGN
    splits = -(-S // chunk_rows)
    if itemsize == 2:
        unit = MMA_ROWS * CONSUMER_WARPS
        row_bytes = pitch_bytes(dk, itemsize) + pitch_bytes(dv, itemsize)
        rows = unit * max(1, min(MAX_ROWS // unit,
                                 STAGE_BYTES // (unit * row_bytes)))
    else:
        groups_per_warp = 32 // lane_width(dk, dv, itemsize)
        rows = min(MAX_ROWS, CONSUMER_WARPS * groups_per_warp * UNROLL)
    # a grid of fewer blocks than SMs gets a whole SM a block
    resident = BLOCKS_PER_SM if groups * splits >= sms else 1
    budget = SMEM_PER_SM // resident - SMEM_RESERVED
    stages = min(MAX_STAGES, -(-chunk_rows // rows))
    while stages > 2 and smem_bytes(dk, dv, itemsize, gc, rows, stages,
                                    splits) > budget:
        stages -= 1  # two stages even past the budget: copies overlap work
    while stages > 1 and smem_bytes(dk, dv, itemsize, gc, rows, stages,
                                    splits) > SMEM_PER_BLOCK:
        stages -= 1
    return Plan(gc, n_chunks, chunk_rows, splits, rows, stages,
                smem_bytes(dk, dv, itemsize, gc, rows, stages, splits))


@functools.lru_cache(maxsize=None)
def card_plan(B: int, S: int, Hq: int, Hkv: int, dk: int, dv: int,
              dtype: torch.dtype, index: int) -> Plan:
    """The plan a launch on card ``index`` uses: ``plan()`` for its SM
    count; a plan meant to run in one wave gets fewer splits while the card
    cannot hold all of its clusters at once (a cluster's blocks share one
    GPC, so the card may hold fewer than ``BLOCKS_PER_SM`` blocks an SM),
    since a second wave of a few clusters would double its time."""
    itemsize = torch.tensor([], dtype=dtype).element_size()
    sms = _sm_count(index)
    with torch.cuda.device(index):
        p = plan(B, S, Hq, Hkv, dk, dv, itemsize, sms)
        groups = B * Hkv * p.n_chunks
        while (1 < p.splits and groups * p.splits <= BLOCKS_PER_SM * sms
               and resident_clusters(p, B, S, Hq, Hkv, dk, dv, dtype)
               < groups):
            p = plan(B, S, Hq, Hkv, dk, dv, itemsize, sms, p.splits - 1)
    return p


def resident_clusters(p: Plan, B: int, S: int, Hq: int, Hkv: int, dk: int,
                      dv: int, dtype: torch.dtype) -> int:
    """How many clusters of plan ``p`` the current card holds at once
    (``cudaOccupancyMaxActiveClusters``); raises if none fits."""
    lib = _build.load("decode_attention")
    n = lib.decode_attention_clusters(
        B, S, Hq, Hkv, dk, dv, p.gc, p.n_chunks, p.chunk_rows, p.splits,
        p.rows, p.stages, int(dtype == torch.bfloat16))
    if n < 1:
        _, err_str = _launcher()
        raise RuntimeError(f"decode_attention plan {p} does not fit: "
                           f"{err_str(n).decode()}")
    return n


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
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q must be [B, Hq, dk], k [B, S, Hkv, dk] and v "
                         f"[B, S, Hkv, dv]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    B, Hq, dk = q.shape
    if k.shape[0] != B or k.shape[3] != dk or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"k must be [B={B}, S, Hkv, dk={dk}] and v [B, S, "
                         f"Hkv, dv] over the same rows; got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if length.shape != (B,):
        raise ValueError(f"length must be [B={B}], got {tuple(length.shape)}")
    if k.shape[1] == 0:
        raise ValueError("the cache holds no rows (S = 0)")
    if k.shape[2] == 0 or Hq % k.shape[2]:
        raise ValueError(f"q heads {Hq} are not a multiple of kv heads "
                         f"{k.shape[2]}")
    check_head_dims(dk, v.shape[3], q.element_size())
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} and Hq={Hq} must be at most 65535 (grid)")
    if B * k.shape[1] + MAX_ROWS >= 2 ** 31:
        raise ValueError(f"B * S = {B * k.shape[1]} cached rows must stay "
                         f"below 2^31 - {MAX_ROWS} (TMA row coordinate)")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(dk)) v over the first ``length[b]`` cached rows
    of each batch row b, on the card, in one kernel launch. q [B, Hq, dk],
    k [B, S, Hkv, dk] and v [B, S, Hkv, dv] with Hq % Hkv == 0, all
    bfloat16 or all float32, dk and dv whole 16-byte vectors up to 256, and
    ``length`` [B] int32, contiguous on one CUDA device -> [B, Hq, dv] in
    q's dtype; rows with ``length == 0`` are zeros."""
    global launches
    _check(q, k, v, length)
    B, Hq, dk = q.shape
    S, Hkv, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, Hq, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    p = card_plan(B, S, Hq, Hkv, dk, dv, q.dtype, q.device.index or 0)
    fn, err_str = _launcher()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                 out.data_ptr(), B, S, Hq, Hkv, dk, dv, p.gc, p.n_chunks,
                 p.chunk_rows, p.splits, p.rows, p.stages, dk ** -0.5,
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention launch failed: CUDA error "
                           f"{err} ({err_str(err).decode()})")
    launches += 1
    return out
