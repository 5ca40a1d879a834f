"""Pace controller (paper §IV-B): data-free convergence detection per block
(counterpart of ``repro/core/pace.py``).

Block perturbation over an update window Q (Eq. 2):

    P_t^{r,Q} = || sum_{q<Q} W_t^{r-q} || / sum_{q<Q} || W_t^{r-q} ||

The numerator telescopes to theta^r - theta^{r-Q}, so the window holds flat
fp32 snapshots and a FIFO of scalar update norms. ``low_memory=True`` keeps
an anchored (hopping) window of two copies instead of Q+1. A smoothing
window H (Eq. 3) and a least-squares slope test (|slope| < Lambda for mu
consecutive rounds) gate the freeze. ``state_dict``/``load_state_dict``
serialize the whole window and decision state as numpy arrays.

The window lives where the observed block lives, picked at the first
observe by the device of the block's leaves:

  * a CPU block keeps the reference's arithmetic bit for bit
    (``_HostWindow``): flat f32 numpy snapshots, both norms in numpy
    float64;
  * a CUDA block keeps its snapshots on the card as flat f32 tensors
    (``_TensorWindow``) and takes both norms through
    ``kernels.ops.diff_sqnorm`` (kernel B3), leaf by leaf against views of
    the snapshots: the difference in f32 and the square and sum in f64, as
    numpy does, so the norms agree with the numpy path to about 1e-15
    relative and the freeze decisions are the reference's. The block never
    goes to the host. This is where the reference's own docstring puts the
    norms ("computed on-mesh (kernels/block_perturb for the fused norm)").

The decision logic (``_emit``, ``slope``, ``should_freeze``) is shared.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.module import tree_leaves

Norms = Tuple[Optional[float], Optional[float]]


def _flatten(leaves) -> np.ndarray:
    """One contiguous fp32 host vector per observation, leaves in
    ``tree_leaves`` order (one device-to-host copy)."""
    flat = [l.detach().reshape(-1).float() for l in leaves]
    if not flat:
        return np.zeros(0, np.float32)
    return torch.cat(flat).cpu().numpy()


def _norm(v: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.square(v, dtype=np.float64))))


class _HostWindow:
    """Snapshots as flat f32 numpy vectors, norms in numpy float64: the
    reference's arithmetic, bit for bit."""

    def __init__(self, window_q: int, low_memory: bool):
        self.q, self.low_memory = window_q, low_memory
        self.ring: Deque[np.ndarray] = deque()   # exact window
        self.anchor: Optional[np.ndarray] = None  # boundary (low_memory)
        self.prev: Optional[np.ndarray] = None    # theta^{r-1} (low_memory)

    def take(self, leaves) -> Optional[np.ndarray]:
        """The block's snapshot, or None when it holds a non-finite value."""
        flat = _flatten(leaves)
        return flat if bool(np.isfinite(flat).all()) else None

    def push(self, flat: np.ndarray, hop: bool) -> Norms:
        """Ingest a finite snapshot. Returns (the update norm against the
        previous snapshot, the window numerator), each None where the
        reference has none; ``hop`` re-anchors the low-memory window."""
        if self.low_memory:
            if self.prev is None:
                self.prev = self.anchor = flat
                return None, None
            if hop:
                self.anchor = self.prev
            upd = _norm(flat - self.prev)
            self.prev = flat
            return upd, _norm(flat - self.anchor)
        upd = _norm(flat - self.ring[-1]) if self.ring else None
        self.ring.append(flat)
        if len(self.ring) > self.q + 1:
            self.ring.popleft()
        if len(self.ring) < 2:
            return upd, None
        return upd, _norm(self.ring[-1] - self.ring[0])

    def state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(window [w, n], anchor, prev) as the reference serializes them."""
        n = self.ring[-1].size if self.ring else (
            self.prev.size if self.prev is not None else 0)
        empty = np.zeros((0,), np.float32)
        return (np.stack(self.ring) if self.ring
                else np.zeros((0, n), np.float32),
                self.anchor if self.anchor is not None else empty,
                self.prev if self.prev is not None else empty)

    def load(self, window, anchor, prev) -> None:
        self.ring = deque(list(np.asarray(window, np.float32)))
        anchor = np.asarray(anchor, np.float32)
        prev = np.asarray(prev, np.float32)
        self.anchor = anchor if anchor.size else None
        self.prev = prev if prev.size else None


def check_window_fits(n: int, copies: int, low_memory: bool,
                      device: torch.device) -> None:
    """Raise before allocating a card window of ``copies`` f32 copies of an
    n-element block that would not fit: the copies, plus the transient
    memory the caller's round has needed so far (the peak allocation above
    what is held now), against what the card has free
    (``torch.cuda.mem_get_info``) and what the caching allocator holds
    unused. The window never moves to the host on its own."""
    need = copies * n * 4
    free, _ = torch.cuda.mem_get_info(device)
    held = torch.cuda.memory_allocated(device)
    spare = torch.cuda.memory_reserved(device) - held
    transient = torch.cuda.max_memory_allocated(device) - held
    if need + transient <= free + spare:
        return
    hint = ("" if low_memory else
            "; pass pace_kwargs with low_memory=True for the anchored "
            "window's two copies")
    raise ValueError(
        f"the pace window needs {copies} float32 copies of the "
        f"{n}-element block ({need / 1e9:.2f} GB) beside the "
        f"{transient / 1e9:.2f} GB the round's transients took, and "
        f"{device} has {(free + spare) / 1e9:.2f} GB free{hint}")


class _TensorWindow:
    """Snapshots as flat f32 tensors on the block's device, norms by
    ``ops.diff_sqnorm`` (kernel B3 on the card, its f64 plain version on
    the CPU). Holds no more than the window's own copies: the norms are
    taken leaf by leaf against views of the snapshots, and the new snapshot
    is then written into the buffer it replaces (the old ``prev`` unless
    that is the anchor, or the slot the exact window drops)."""

    def __init__(self, window_q: int, low_memory: bool, device):
        self.q, self.low_memory = window_q, low_memory
        self.device = torch.device(device)
        self.ring: Deque[torch.Tensor] = deque()
        self.anchor: Optional[torch.Tensor] = None
        self.prev: Optional[torch.Tensor] = None
        self.sizes: Optional[List[int]] = None
        self.checked = False

    def _fit(self, n: int) -> None:
        if self.device.type == "cuda" and not self.checked:
            copies = 2 if self.low_memory else self.q + 1
            check_window_fits(n, copies, self.low_memory, self.device)
        self.checked = True

    def take(self, leaves) -> Optional[List[torch.Tensor]]:
        """The block's leaves as flat views, or None when one holds a
        non-finite value (one device sync)."""
        flat = [l.detach().reshape(-1) for l in leaves]
        if flat and not bool(torch.stack(
                [torch.isfinite(l).all() for l in flat]).all()):
            return None
        return flat

    def _sqnorms(self, leaves, snaps) -> List[float]:
        """For each snapshot, the block's squared distance to it: leaf by
        leaf against the snapshot's views, summed exactly (``math.fsum``)
        after one device sync."""
        if not snaps:
            return []
        parts, off = [], 0
        for leaf in leaves:
            n = leaf.numel()
            parts += [ops.diff_sqnorm(leaf, s[off:off + n]) for s in snaps]
            off += n
        if not parts:
            return [0.0] * len(snaps)
        vals = torch.stack(parts).tolist()
        return [math.fsum(vals[i::len(snaps)]) for i in range(len(snaps))]

    def _write(self, leaves, buf: Optional[torch.Tensor]) -> torch.Tensor:
        """The block as a flat f32 snapshot, into ``buf`` (a buffer the
        window drops) or a new one."""
        sizes = [l.numel() for l in leaves]
        if self.sizes is None:
            self.sizes = sizes
        elif sizes != self.sizes:
            raise ValueError(f"the observed block's leaf sizes changed: "
                             f"{self.sizes} -> {sizes}")
        if buf is None:
            self._fit(sum(sizes))
            buf = torch.empty(sum(sizes), dtype=torch.float32,
                              device=self.device)
        off = 0
        for leaf, n in zip(leaves, sizes):
            buf[off:off + n].copy_(leaf)
            off += n
        return buf

    def push(self, leaves, hop: bool) -> Norms:
        """As ``_HostWindow.push``; both norms are taken before the new
        snapshot overwrites anything."""
        if self.low_memory:
            if self.prev is None:
                self.prev = self.anchor = self._write(leaves, None)
                return None, None
            anchor = self.prev if hop else self.anchor
            upd2, num2 = self._sqnorms(leaves, [self.prev, anchor])
            old = self.anchor if hop else self.prev
            self.prev = self._write(leaves, old if old is not anchor else None)
            self.anchor = anchor
            return math.sqrt(upd2), math.sqrt(num2)
        prev = self.ring[-1] if self.ring else None
        drop = len(self.ring) > self.q  # the ring is full: its oldest goes
        kept = list(self.ring)[1 if drop else 0:]
        anchor = kept[0] if kept else None  # theta^{r-Q} once this one is in
        sq = self._sqnorms(leaves, [s for s in (prev, anchor)
                                    if s is not None])
        buf = self.ring.popleft() if drop else None
        self.ring.append(self._write(leaves, buf))
        return (None if prev is None else math.sqrt(sq[0]),
                None if anchor is None else math.sqrt(sq[-1]))

    def state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        host = _HostWindow(self.q, self.low_memory)
        host.ring = deque(t.cpu().numpy() for t in self.ring)
        host.anchor = None if self.anchor is None else self.anchor.cpu().numpy()
        host.prev = None if self.prev is None else self.prev.cpu().numpy()
        return host.state()

    def load(self, window, anchor, prev) -> None:
        host = _HostWindow(self.q, self.low_memory)
        host.load(window, anchor, prev)
        n = max([a.size for a in (*host.ring, host.anchor, host.prev)
                 if a is not None], default=0)
        if n:
            self._fit(n)
        self.ring = deque(torch.as_tensor(a, device=self.device)
                          for a in host.ring)
        self.anchor, self.prev = (
            None if a is None else torch.as_tensor(a, device=self.device)
            for a in (host.anchor, host.prev))


def _new_window(leaves, window_q: int, low_memory: bool):
    """The window for a block whose leaves are ``leaves``: on the card for
    a CUDA block, numpy on the host otherwise."""
    if leaves and leaves[0].device.type == "cuda":
        return _TensorWindow(window_q, low_memory, leaves[0].device)
    return _HostWindow(window_q, low_memory)


@dataclass
class PaceController:
    """One controller instance per SmartFreeze block (the active one)."""

    window_q: int = 5        # Eq. 2 update window
    smooth_h: int = 5        # Eq. 3 smoothing window
    slope_lambda: float = 2e-3   # freeze threshold on |slope|
    mu: int = 3              # consecutive rounds below threshold
    fit_window: int = 8      # points used for the least-squares fit
    min_rounds: int = 10     # never freeze before this many rounds
    low_memory: bool = False  # anchored window: 2 block copies instead of Q+1

    _win: Optional[object] = None    # picked at the first observe
    _loaded: Optional[tuple] = None  # (window, anchor, prev) awaiting _win
    _update_norms: Deque = field(default_factory=deque)
    _perturbations: List[float] = field(default_factory=list)
    _smoothed: List[float] = field(default_factory=list)
    _below: int = 0
    _rounds: int = 0
    _skipped: int = 0    # non-finite observations dropped

    def observe(self, block_params) -> Optional[float]:
        """Call once per round with the aggregated active-block params.
        Returns the smoothed block perturbation (None until >= 2 rounds).

        Non-finite params are rejected, not ingested: one NaN snapshot
        would poison the update norms for Q rounds and the smoothed series
        for good. The observation is counted in ``_skipped`` and the
        previous smoothed value is returned."""
        leaves = tree_leaves(block_params)
        if self._win is None:
            self._win = _new_window(leaves, self.window_q, self.low_memory)
            if self._loaded is not None:
                self._win.load(*self._loaded)
                self._loaded = None
        snap = self._win.take(leaves)
        if snap is None:
            self._skipped += 1
            return self._smoothed[-1] if self._smoothed else None
        if self.low_memory:
            self._rounds += 1
            # hop: restart the window one update back (length cycles 1..Q)
            hop = len(self._update_norms) >= self.window_q
            upd, num = self._win.push(snap, hop)
            if upd is None:
                return None
            if hop:
                self._update_norms.clear()
            self._update_norms.append(upd)
            return self._emit(num, sum(self._update_norms))
        upd, num = self._win.push(snap, False)
        if upd is not None:
            self._update_norms.append(upd)
            if len(self._update_norms) > self.window_q:
                self._update_norms.popleft()
        self._rounds += 1
        if num is None:
            return None
        return self._emit(num, sum(self._update_norms))

    def _emit(self, num: float, den: float) -> float:
        p = num / (den + 1e-12)
        self._perturbations.append(p)
        h = min(self.smooth_h, len(self._perturbations))
        sm = float(np.mean(self._perturbations[-h:]))
        self._smoothed.append(sm)
        return sm

    def slope(self) -> Optional[float]:
        n = min(self.fit_window, len(self._smoothed))
        if n < 3:
            return None
        y = np.asarray(self._smoothed[-n:], np.float64)
        x = np.arange(n, dtype=np.float64)
        return float(np.polyfit(x, y, 1)[0])

    def should_freeze(self) -> bool:
        if self._rounds < self.min_rounds:
            return False
        s = self.slope()
        if s is None:
            return False
        if abs(s) < self.slope_lambda:
            self._below += 1
        else:
            self._below = 0
        return self._below >= self.mu

    @property
    def history(self):
        return {"perturbation": list(self._perturbations),
                "smoothed": list(self._smoothed), "rounds": self._rounds,
                "skipped": self._skipped}

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Full controller state as numpy arrays, the same on either window
        (a card window's snapshots are copied to the host)."""
        win = self._win
        if win is None:
            win = _HostWindow(self.window_q, self.low_memory)
            if self._loaded is not None:
                win.load(*self._loaded)
        window, anchor, prev = win.state()
        return {
            "window": window,
            "anchor": anchor,
            "prev": prev,
            "update_norms": np.asarray(list(self._update_norms), np.float64),
            "perturbations": np.asarray(self._perturbations, np.float64),
            "smoothed": np.asarray(self._smoothed, np.float64),
            "counters": np.asarray([self._below, self._rounds,
                                    self._skipped], np.int64),
        }

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> "PaceController":
        """Restore ``state``; the window is placed on the device of the next
        observed block."""
        self._win = None
        self._loaded = (state["window"], state["anchor"], state["prev"])
        self._update_norms = deque(
            float(x) for x in np.asarray(state["update_norms"]))
        self._perturbations = [float(x)
                               for x in np.asarray(state["perturbations"])]
        self._smoothed = [float(x) for x in np.asarray(state["smoothed"])]
        cs = [int(x) for x in np.asarray(state["counters"])]
        self._below, self._rounds = cs[0], cs[1]
        # the reference's older checkpoints carry a 2-entry counter vector
        self._skipped = cs[2] if len(cs) > 2 else 0
        return self


# ---------------------------------------------------------------------------
# Ablation schedules (paper Table II comparisons)
# ---------------------------------------------------------------------------


def naive_equal_schedule(total_rounds: int, num_blocks: int) -> List[int]:
    """(c) rounds allocated proportional to block index (param-count proxy)."""
    base = total_rounds // num_blocks
    return [base] * num_blocks


def front_loaded_schedule(total_rounds: int, num_blocks: int) -> List[int]:
    """(b) freeze early blocks prematurely; spend rounds on the last block."""
    early = max(total_rounds // (4 * num_blocks), 1)
    sched = [early] * (num_blocks - 1)
    sched.append(total_rounds - sum(sched))
    return sched
