"""Per-stage participant selection (paper §IV-C, Eqs. 11-14; numpy copy of
``repro/core/selector/selection.py``).

Pipeline per stage t:
  1. hard memory filter:   M(i, t) >= M_train(Theta_t)            (Eq. 12)
  2. feasibility check:    #eligible >= phi                        (Eq. 14)
  3. diversity:            cover RL-CD communities round-robin     (max Div)
  4. within community:     epsilon-greedy bandit on
                           Util_i = I_{t,i} - lambda * t_t^i       (Eq. 11)

This decouples the compound objective exactly as the paper does: community
coverage maximizes Div(S, t); the bandit maximizes sum Util.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.selector.bandit import UtilBandit, mix_seed
from repro_torch.core.selector.rlcd import rlcd_communities


@dataclass
class ClientInfo:
    client_id: int
    memory_bytes: float          # device memory capacity
    capability: float            # runtime training capability c_i (FLOP/s)
    num_samples: int             # |D_i|
    loss_sum: float = 0.0        # I_{t,i}: summed local loss (Eq. 9)


class InfeasibleStageError(RuntimeError):
    """Eq. 14 violated: too few clients can fit the stage sub-model."""


@dataclass
class ParticipantSelector:
    lam: float = 1e-3            # lambda in Eq. 11
    epsilon: float = 0.2
    phi: int = 2                 # Eq. 14 minimum eligible clients
    seed: int = 0
    _bandit: UtilBandit = field(default=None)
    _communities: Optional[List[List[int]]] = None

    def __post_init__(self):
        if self._bandit is None:
            self._bandit = UtilBandit(epsilon=self.epsilon, seed=self.seed)

    # ----- setup -----

    def fit_communities(self, similarity: np.ndarray):
        self._communities = rlcd_communities(similarity, seed=self.seed)
        return self._communities

    # ----- per-round selection -----

    def eligible(self, clients: Dict[int, ClientInfo], mem_required: float
                 ) -> List[int]:
        return [cid for cid, c in clients.items() if c.memory_bytes >= mem_required]

    def utilities(self, clients: Dict[int, ClientInfo], stage_time_fn) -> Dict[int, float]:
        """Util_i = I_{t,i} - lambda * t_t^i (Eq. 11 per-client term)."""
        return {cid: c.loss_sum - self.lam * stage_time_fn(c)
                for cid, c in clients.items()}

    def select(self, clients: Dict[int, ClientInfo], k: int, *,
               mem_required: float, stage_time_fn) -> List[int]:
        elig = self.eligible(clients, mem_required)
        if len(elig) < self.phi:
            raise InfeasibleStageError(
                f"only {len(elig)} clients fit {mem_required / 2**20:.0f} MiB "
                f"(phi={self.phi}) — repartition blocks or lower batch size")
        utils = self.utilities({c: clients[c] for c in elig}, stage_time_fn)
        for cid, u in utils.items():
            self._bandit.update(cid, u)
        self._bandit.next_round()

        if not self._communities:
            return self._bandit.pick(elig, min(k, len(elig)))

        # round-robin across communities (maximize Div), bandit within
        chosen: List[int] = []
        pools = [[c for c in comm if c in set(elig)] for comm in self._communities]
        pools = [p for p in pools if p]
        rng = np.random.RandomState(mix_seed(self.seed, self._bandit._round))
        order = rng.permutation(len(pools))
        ci = 0
        while len(chosen) < min(k, len(elig)) and pools:
            pool = pools[order[ci % len(pools)] % len(pools)]
            remaining = [c for c in pool if c not in chosen]
            if remaining:
                pick = self._bandit.pick(remaining, 1)
                chosen.extend(pick)
            else:
                pools = [p for p in pools if any(c not in chosen for c in p)]
                order = rng.permutation(len(pools)) if pools else order
            ci += 1
        return chosen
