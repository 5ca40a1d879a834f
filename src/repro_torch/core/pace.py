"""Pace controller (paper §IV-B): data-free convergence detection per block
(counterpart of ``repro/core/pace.py``; numpy, as in the reference).

Block perturbation over an update window Q (Eq. 2):

    P_t^{r,Q} = || sum_{q<Q} W_t^{r-q} || / sum_{q<Q} || W_t^{r-q} ||

The numerator telescopes to theta^r - theta^{r-Q}, so the window holds flat
fp32 snapshots and a FIFO of scalar update norms. ``low_memory=True`` keeps
an anchored (hopping) window of two copies instead of Q+1. A smoothing
window H (Eq. 3) and a least-squares slope test (|slope| < Lambda for mu
consecutive rounds) gate the freeze. ``state_dict``/``load_state_dict``
serialize the whole window and decision state as numpy arrays.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.module import tree_leaves


def _flatten(block_params) -> np.ndarray:
    """One contiguous fp32 host vector per observation, leaves in
    ``tree_leaves`` order (one device-to-host copy)."""
    leaves = [l.detach().reshape(-1).float() for l in tree_leaves(block_params)]
    if not leaves:
        return np.zeros(0, np.float32)
    return torch.cat(leaves).cpu().numpy()


def _norm(v: np.ndarray) -> float:
    return float(np.sqrt(np.sum(np.square(v, dtype=np.float64))))


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

    _window: Deque = field(default_factory=deque)      # flat snapshots (exact)
    _anchor: Optional[np.ndarray] = None               # boundary (low_memory)
    _prev: Optional[np.ndarray] = None                 # theta^{r-1} (low_memory)
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
        flat = _flatten(block_params)
        if not bool(np.isfinite(flat).all()):
            self._skipped += 1
            return self._smoothed[-1] if self._smoothed else None
        if self.low_memory:
            return self._observe_anchored(flat)
        if self._window:
            self._update_norms.append(_norm(flat - self._window[-1]))
            if len(self._update_norms) > self.window_q:
                self._update_norms.popleft()
        self._window.append(flat)
        if len(self._window) > self.window_q + 1:
            self._window.popleft()
        self._rounds += 1
        if len(self._window) < 2:
            return None
        num = _norm(self._window[-1] - self._window[0])
        return self._emit(num, sum(self._update_norms))

    def _observe_anchored(self, flat: np.ndarray) -> Optional[float]:
        self._rounds += 1
        if self._prev is None:
            self._prev = flat
            self._anchor = flat
            return None
        if len(self._update_norms) >= self.window_q:
            # hop: restart the window one update back (length cycles 1..Q)
            self._anchor = self._prev
            self._update_norms.clear()
        self._update_norms.append(_norm(flat - self._prev))
        self._prev = flat
        num = _norm(flat - self._anchor)
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
        """Full controller state as numpy arrays."""
        n = self._window[-1].size if self._window else (
            self._prev.size if self._prev is not None else 0)
        return {
            "window": (np.stack(self._window) if self._window
                       else np.zeros((0, n), np.float32)),
            "anchor": (self._anchor if self._anchor is not None
                       else np.zeros((0,), np.float32)),
            "prev": (self._prev if self._prev is not None
                     else np.zeros((0,), np.float32)),
            "update_norms": np.asarray(list(self._update_norms), np.float64),
            "perturbations": np.asarray(self._perturbations, np.float64),
            "smoothed": np.asarray(self._smoothed, np.float64),
            "counters": np.asarray([self._below, self._rounds,
                                    self._skipped], np.int64),
        }

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> "PaceController":
        w = np.asarray(state["window"], np.float32)
        self._window = deque(list(w))
        anchor = np.asarray(state["anchor"], np.float32)
        prev = np.asarray(state["prev"], np.float32)
        self._anchor = anchor if anchor.size else None
        self._prev = prev if prev.size else None
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
