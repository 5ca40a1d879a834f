"""epsilon-greedy multi-armed bandit over client utility (paper §IV-C6;
numpy copy of ``repro/core/selector/bandit.py``).

Util_i = I_{t,i} - lambda * t_t^i  (data importance minus weighted time).
Clients not selected recently have stale Util, so the bandit explores a
fraction epsilon of slots among under-observed clients (Oort-style)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np


def mix_seed(seed: int, round_idx: int) -> int:
    """Decorrelated per-round RNG seed. The old ``seed + round`` scheme made
    (seed=0, round=1) and (seed=1, round=0) share a stream, so two selectors
    with different seeds walked each other's exploration schedules one round
    apart. Multiplying the seed onto a large odd constant separates the
    streams; shared by UtilBandit and ParticipantSelector."""
    return (seed * 1_000_003 + round_idx) % (2 ** 32)


@dataclass
class UtilBandit:
    epsilon: float = 0.2
    seed: int = 0
    _util: Dict[int, float] = field(default_factory=dict)
    _last_seen: Dict[int, int] = field(default_factory=dict)
    _round: int = 0

    def update(self, client_id: int, util: float):
        self._util[client_id] = float(util)
        self._last_seen[client_id] = self._round

    def next_round(self):
        self._round += 1

    def pick(self, candidates: Sequence[int], k: int) -> List[int]:
        """Pick k clients: (1-eps) exploit by Util, eps explore stalest."""
        rng = np.random.RandomState(mix_seed(self.seed, self._round))
        cands = list(candidates)
        if len(cands) <= k:
            return cands
        n_explore = int(round(self.epsilon * k))
        n_exploit = k - n_explore
        by_util = sorted(cands, key=lambda c: self._util.get(c, -np.inf),
                         reverse=True)
        exploit = by_util[:n_exploit]
        rest = [c for c in cands if c not in exploit]
        # explore the least recently observed (never-seen first)
        rest.sort(key=lambda c: (self._last_seen.get(c, -1), rng.rand()))
        explore = rest[:n_explore]
        return exploit + explore
