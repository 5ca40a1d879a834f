"""Virtual-time federated simulation loop, sync policy (counterpart of
``repro/fl/sim.py``'s ``FleetTimeModel``, ``RoundRecord``,
``SyncAggregation`` and ``FederatedLoop``; numpy).

``FederatedLoop`` replays selection -> local training -> aggregation ->
observation once per virtual tick. ``SyncAggregation`` is the Eq. 7
barrier: a round lasts as long as its slowest selected client. The
deadline and async policies, availability traces and fault injection are
not ported; ``resolve_policy`` accepts ``"sync"`` only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.time_model import (cohort_round_time, completion_jitter,
                                         completion_times, stage_times,
                                         uplink_times)


@dataclass
class FleetTimeModel:
    """Per-client round completion times in virtual seconds.

    ``compute_s[i]`` is client i's base local-training time (Eq. 6; the
    default ``from_clients`` model is ``|D_i| / c_i``, the selection
    heuristic), ``link_rate[i]`` its uplink in bytes/s (``inf`` = free
    network); the server sets ``payload_bytes`` per stage."""

    client_ids: np.ndarray                 # [N] external ids
    compute_s: np.ndarray                  # [N] f32 seconds
    link_rate: np.ndarray                  # [N] f32 bytes/s (inf ok)
    jitter: float = 0.0                    # lognormal sigma (0 = off)
    seed: int = 0
    payload_bytes: float = 0.0             # per-client uplink payload
    compute_scale: Optional[np.ndarray] = None  # [N] f32 (None = ones)
    _row: Dict[int, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.client_ids = np.asarray(self.client_ids)
        self.compute_s = np.asarray(self.compute_s, np.float32)
        self.link_rate = np.asarray(self.link_rate, np.float32)
        if self.compute_scale is not None:
            self.compute_scale = np.asarray(self.compute_scale, np.float32)
        self._row = {int(c): i for i, c in enumerate(self.client_ids)}

    def with_compute_scale(self, scale_of: Dict[int, float]
                           ) -> "FleetTimeModel":
        """Copy with per-client compute-time multipliers (1.0 elsewhere):
        feature-cache admission shortens a cached client's local step."""
        scale = (self.compute_scale.copy() if self.compute_scale is not None
                 else np.ones(len(self.client_ids), np.float32))
        for cid, s in scale_of.items():
            scale[self._row[int(cid)]] = float(s)
        return dataclasses.replace(self, compute_scale=scale)

    @classmethod
    def from_clients(cls, clients, *, flops_per_sample: float = 1.0,
                     rho: float = 1.0, link_rates=None, jitter: float = 0.0,
                     seed: int = 0) -> "FleetTimeModel":
        """Build from a ``SimClient`` fleet (list or id-keyed dict).
        ``link_rates`` aligns with the given client order (list) or is an
        id-keyed dict; rows are stored sorted by client id."""
        cs = list(clients.values()) if isinstance(clients, dict) else list(clients)
        if link_rates is None:
            rate_of = {c.client_id: getattr(c, "link_rate", np.inf) for c in cs}
        elif isinstance(link_rates, dict):
            rate_of = dict(link_rates)
        else:
            if len(link_rates) != len(cs):
                raise ValueError(f"link_rates has {len(link_rates)} entries "
                                 f"for {len(cs)} clients")
            rate_of = {c.client_id: r for c, r in zip(cs, link_rates)}
        cs = sorted(cs, key=lambda c: c.client_id)
        n = np.asarray([c.num_samples for c in cs], np.float32)
        cap = np.asarray([c.capability for c in cs], np.float32)
        return cls(client_ids=np.asarray([c.client_id for c in cs]),
                   compute_s=stage_times(flops_per_sample, n, cap, rho),
                   link_rate=np.asarray([rate_of[c.client_id] for c in cs],
                                        np.float32),
                   jitter=jitter, seed=seed)

    def population_times(self, round_idx: int) -> np.ndarray:
        """[N] completion times for the whole fleet."""
        jit = completion_jitter(len(self.client_ids), self.seed, round_idx,
                                self.jitter)
        up = uplink_times(self.payload_bytes, self.link_rate)
        compute = (self.compute_s if self.compute_scale is None
                   else self.compute_s * self.compute_scale)
        return completion_times(compute, up, jit)

    def cohort_times(self, cohort: Sequence[int], round_idx: int
                     ) -> Dict[int, float]:
        """Completion time per selected client id."""
        if not len(cohort):
            return {}
        t = self.population_times(round_idx)
        return {int(c): float(t[self._row[int(c)]]) for c in cohort}


@dataclass
class RoundRecord:
    """What one virtual tick did."""
    round_idx: int
    selected: List[int]                    # clients whose updates aggregated
    losses: Dict[int, float]
    t_start: float = 0.0
    duration: float = 0.0
    t_end: float = 0.0


class SyncAggregation:
    """Eq. 7 barrier: everyone selected trains; the round lasts as long as
    the slowest of them."""

    def tick(self, loop: "FederatedLoop", r: int) -> RoundRecord:
        cohort = loop.select_fn(r, list(loop.client_ids))
        times = loop.times(cohort, r)
        losses = loop.train_fn(cohort, r) if cohort else {}
        dur = cohort_round_time([times[c] for c in cohort])
        return RoundRecord(r, list(cohort), losses, t_start=loop.clock,
                           duration=dur, t_end=loop.clock + dur)


def resolve_policy(policy) -> Any:
    """'sync' | a ``SyncAggregation`` -> policy instance. The deadline and
    async policies are not ported."""
    if isinstance(policy, SyncAggregation):
        return policy
    if policy == "sync":
        return SyncAggregation()
    raise ValueError(f"aggregation policy {policy!r} is not ported; "
                     "only 'sync'")


@dataclass
class FederatedLoop:
    """Selection -> local training -> aggregation -> observation per tick.

    Hooks (closures over the trainer's own model state):

      select_fn(round_idx, available_ids) -> cohort ids
      train_fn(cohort, round_idx) -> {cid: mean loss}; runs the round and
          applies the aggregate to the trainer's model
      on_round(RoundRecord) -> truthy to stop (pace freeze, budget, ...)

    ``time_model=None`` builds the default ``|D_i| / c_i`` model from the
    fleet, or zero times with no fleet.
    """

    select_fn: Callable[[int, List[int]], List[int]] = None
    train_fn: Callable[..., Dict[int, float]] = None
    clients: Optional[Dict[int, Any]] = None
    client_ids: Optional[List[int]] = None
    aggregation: Union[str, Any] = "sync"
    time_model: Optional[FleetTimeModel] = None
    on_round: Optional[Callable[[RoundRecord], Optional[bool]]] = None
    clock: float = 0.0
    history: List[RoundRecord] = field(default_factory=list)

    def __post_init__(self):
        self.aggregation = resolve_policy(self.aggregation)
        if self.client_ids is None:
            self.client_ids = sorted(self.clients) if self.clients else []
        if self.time_model is None and self.clients:
            self.time_model = FleetTimeModel.from_clients(self.clients)

    def times(self, cohort: Sequence[int], round_idx: int) -> Dict[int, float]:
        if self.time_model is None:
            return {int(c): 0.0 for c in cohort}
        return self.time_model.cohort_times(cohort, round_idx)

    def run(self, n_rounds: int, *, start_round: int = 0) -> List[RoundRecord]:
        """Run ``n_rounds`` ticks with global indices from ``start_round``
        (global indices keep per-(client, round) batch plans stable across
        stages)."""
        out: List[RoundRecord] = []
        for r in range(start_round, start_round + n_rounds):
            rec = self.aggregation.tick(self, r)
            self.clock = rec.t_end
            self.history.append(rec)
            out.append(rec)
            if self.on_round is not None and self.on_round(rec):
                break
        return out
