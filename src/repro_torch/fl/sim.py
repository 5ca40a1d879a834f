"""Virtual-time federated simulation loop (counterpart of
``repro/fl/sim.py``'s ``FleetTimeModel``, ``AvailabilityTrace``,
``RoundRecord``, the three aggregation policies and ``FederatedLoop``;
numpy on the host, model trees on the trainer's device).

``FederatedLoop`` replays selection -> local training -> aggregation ->
observation once per virtual tick, and the policy drives it:

  * ``SyncAggregation``: the Eq. 7 barrier; a round lasts as long as its
    slowest surviving client.
  * ``DeadlineAggregation``: the paper's partial aggregation (§IV-C);
    clients finishing after T_dl are dropped, and straggler rounds run the
    engine's sequential escape hatch.
  * ``AsyncBufferedAggregation``: FedBuff-style buffered async; clients
    train from the params version they were dispatched at, and every
    ``buffer_size`` completions merge with staleness-discounted Eq. 1
    weights; a virtual-clock watchdog re-dispatches slow clients.

``AvailabilityTrace`` draws per-(client, round) availability and mid-round
dropout with the reference's splitmix64 hash (``fl/faults.hash_draws``),
bit for bit. ``FederatedLoop(faults=FaultInjector(...))`` injects faults:
under sync and deadline a crashed or hung client loses its update while
its compute still counts toward the barrier, and the corruption kinds
reach the trainer hook as ``faults={cid: kind}``; the async policy's
faults are its own (``AsyncBufferedAggregation``). The client mesh is
not ported: ``FederatedLoop`` takes no ``mesh``.

The checkpoint helpers (``pack_rng_state``, ``selector_state_tree``,
``pack_float_map``, their inverses, and ``tree_like``, which casts a
restored tree onto a live one's dtypes and devices) give the servers and
the LM trainer the reference's checkpoint leaves.
"""
from __future__ import annotations

import dataclasses
import heapq
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import pack_ragged, unpack_ragged
from repro_torch.core.time_model import (cohort_round_time, completion_jitter,
                                         completion_times, stage_times,
                                         uplink_times)
from repro_torch.fl.faults import (CORRUPT_KINDS, FaultInjector,
                                   apply_fault_to_update, hash_draws)
from repro_torch.models.module import tree_leaves, tree_map


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
class AvailabilityTrace:
    """Client availability and mid-round dropout, seeded per (client,
    round). ``p_available`` gates whether a client can be selected this
    round; ``p_dropout`` kills a selected client mid-round (its update
    never reaches the server)."""

    p_available: float = 1.0
    p_dropout: float = 0.0
    seed: int = 0

    def available(self, ids: Sequence[int], round_idx: int) -> List[int]:
        ids = list(ids)
        if self.p_available >= 1.0 or not ids:
            return ids
        u = hash_draws(self.seed, round_idx, ids)
        return [c for c, ui in zip(ids, u) if ui < self.p_available]

    def dropouts(self, cohort: Sequence[int], round_idx: int) -> List[int]:
        cohort = list(cohort)
        if self.p_dropout <= 0.0 or not cohort:
            return []
        u = hash_draws(self.seed + 1, round_idx, cohort)
        return [c for c, ui in zip(cohort, u) if ui < self.p_dropout]


@dataclass
class RoundRecord:
    """What one virtual tick did."""
    round_idx: int
    selected: List[int]                    # clients whose updates aggregated
    losses: Dict[int, float]
    dropped: List[int] = field(default_factory=list)   # late, dropout, retry
    t_start: float = 0.0
    duration: float = 0.0
    t_end: float = 0.0
    policy: str = "sync"
    sequential: bool = False
    staleness: Dict[int, int] = field(default_factory=dict)  # async only
    faults: Dict[int, str] = field(default_factory=dict)     # injected kinds
    retries: Dict[int, int] = field(default_factory=dict)    # async retries


class SyncAggregation:
    """Eq. 7 barrier: everyone selected trains; the round lasts as long as
    the slowest surviving client. A dropped client's update never arrives
    and costs the barrier nothing. An injected crash or hang loses the
    client's update but its compute still counts toward the barrier."""

    name = "sync"

    def tick(self, loop: "FederatedLoop", r: int) -> RoundRecord:
        avail = loop.available(r)
        sel = loop.select_fn(r, avail) if avail else []
        dropped = loop.dropouts(sel, r)
        cohort = [c for c in sel if c not in set(dropped)]
        times = loop.times(sel, r)
        sched = loop.fault_schedule(cohort, r)
        losses, crashed = loop.run_train(cohort, r, schedule=sched)
        survivors = [c for c in cohort if c not in set(crashed)]
        dur = cohort_round_time([times[c] for c in cohort])
        return RoundRecord(r, survivors, losses, dropped=dropped + crashed,
                           t_start=loop.clock, duration=dur,
                           t_end=loop.clock + dur, policy=self.name,
                           faults=dict(sched))


@dataclass
class DeadlineAggregation:
    """Paper §IV-C straggler mitigation: partial aggregation over the
    clients that finish before T_dl. The relative deadline ``factor *
    median(times)`` applies only to cohorts of more than 2, and its trim
    only when at least ``max(min_keep, len(cohort) // 2)`` clients finish;
    ``deadline_s`` is an absolute deadline for any cohort size, which may
    leave nobody. Straggler rounds run the engine's sequential escape
    hatch (``sequential=True``). Injected crashes and hangs are
    ``SyncAggregation``'s."""

    factor: float = 2.0
    deadline_s: Optional[float] = None
    min_keep: int = 2
    name: str = "deadline"
    sequential: bool = True

    def tick(self, loop: "FederatedLoop", r: int) -> RoundRecord:
        avail = loop.available(r)
        sel = loop.select_fn(r, avail) if avail else []
        times = loop.times(sel, r)
        kept, straggler_round = list(sel), False
        deadline = self.deadline_s
        if deadline is not None and sel:
            straggler_round = True
            kept = [c for c in sel if times[c] <= deadline]
        elif len(sel) > 2:
            straggler_round = True
            deadline = float(np.median([times[c] for c in sel])) * self.factor
            finishers = [c for c in sel if times[c] <= deadline]
            if len(finishers) >= max(self.min_keep, len(sel) // 2):
                kept = finishers
        dropped = loop.dropouts(kept, r)
        cohort = [c for c in kept if c not in set(dropped)]
        seq = True if (straggler_round and self.sequential) else None
        sched = loop.fault_schedule(cohort, r)
        losses, crashed = loop.run_train(cohort, r, schedule=sched,
                                         sequential=seq)
        survivors = [c for c in cohort if c not in set(crashed)]
        late = [c for c in sel if c not in set(kept)]
        if late:  # the server waited until the deadline before aggregating
            dur = float(deadline)
        else:
            dur = cohort_round_time([times[c] for c in cohort])
        return RoundRecord(r, survivors, losses,
                           dropped=late + dropped + crashed,
                           t_start=loop.clock, duration=dur,
                           t_end=loop.clock + dur, policy=self.name,
                           sequential=bool(seq), faults=dict(sched))


@dataclass
class AsyncBufferedAggregation:
    """FedBuff-style buffered asynchronous aggregation.

    The server keeps up to ``concurrency`` clients in flight, each training
    from the params version it was dispatched at. One tick is one
    aggregation event: pop completions in virtual-time order until
    ``buffer_size`` updates are buffered, then apply

        params += sum_i w_i * (theta_i - theta_{dispatch(i)}) / sum_i w_i,
        w_i = |D_i| * (1 + staleness_i) ** -staleness_power

    and bump the version. The loop's ``snapshot_fn``, ``train_one_fn``,
    ``get_model_fn`` and ``set_model_fn`` hooks are required. A dispatch
    keeps references to the model trees it started from, so the trainer
    must never write into a tree in place.

    ``timeout_s`` arms a virtual-clock watchdog per dispatch: a client
    whose completion has not landed by ``t_dispatch + timeout_s *
    retry_backoff ** attempt`` is abandoned and re-dispatched from the
    current model, up to ``max_retries`` times, then dropped. The event
    budget bounds a tick's pops, so a retry storm ends.

    Faults (the loop's ``faults``): each dispatch draws its kind, a retry
    on a round index perturbed by its attempt. A crash spends the slot
    and the client's compute and merges nothing. A hang completes at
    +inf, so only the watchdog reclaims it; without one the tick parks it
    and returns short. Corrupted updates go through
    ``apply_fault_to_update``, and a merge-time screen, armed only with
    the injector, drops a non-finite delta instead of folding it."""

    buffer_size: int = 4
    concurrency: int = 8
    staleness_power: float = 0.5
    timeout_s: Optional[float] = None
    max_retries: int = 2
    retry_backoff: float = 2.0
    name: str = "async"

    def tick(self, loop: "FederatedLoop", r: int) -> RoundRecord:
        if loop.train_one_fn is None or loop.set_model_fn is None:
            raise ValueError(f"{self.name} aggregation needs the loop's "
                             "snapshot/train_one/get_model/set_model hooks")
        st = loop.async_state
        t0 = loop.clock
        self._refill(loop, r, t0)
        merged: List[Tuple] = []
        completed: List[int] = []
        losses: Dict[int, float] = {}
        staleness: Dict[int, int] = {}
        dropped: List[int] = []
        faulted: Dict[int, str] = {}
        retries: Dict[int, int] = {}
        clock = t0
        events = 0
        max_events = max(64, 16 * self.buffer_size
                         + 4 * self.concurrency * (self.max_retries + 1))
        while (len(merged) < self.buffer_size and st["in_flight"]
               and events < max_events):
            events += 1
            # (key, seq) is unique, so the heap never compares the trees
            entry = heapq.heappop(st["in_flight"])
            key, _, cid, base_p, base_s, v0, attempt, kind, t_fin = entry
            if not np.isfinite(key):
                # a hang with no watchdog: nothing in flight can complete
                # sooner, so park it and return short
                heapq.heappush(st["in_flight"], entry)
                break
            if kind:
                faulted[cid] = kind
            if key < t_fin:
                # the watchdog fired before the completion: abandon it
                clock = max(clock, key)
                if attempt < self.max_retries:
                    retries[cid] = retries.get(cid, 0) + 1
                    self._dispatch(loop, r, cid, clock, attempt=attempt + 1)
                else:
                    dropped.append(cid)
                    self._refill(loop, r, clock)
                continue
            clock = max(clock, t_fin)
            if kind == "crash":
                # compute spent, update lost: free the slot
                dropped.append(cid)
                self._refill(loop, r, clock)
                continue
            p_i, s_i, loss = loop.train_one_fn(cid, base_p, base_s, r)
            if kind in CORRUPT_KINDS:
                p_i = apply_fault_to_update(kind, base_p, p_i,
                                            amplify=loop.faults.amplify)
                if kind in ("nan", "inf"):
                    loss = float("nan")
            stale = st["version"] - v0
            w = (loop.client_weight(cid)
                 * (1.0 + stale) ** -self.staleness_power)
            delta = tree_map(lambda a, b: a.float() - b.float(), p_i, base_p)
            if loop.faults is not None and not all(
                    bool(torch.isfinite(x).all())
                    for x in tree_leaves(delta)):
                # merge-time screen: never fold a non-finite delta into the
                # running model
                dropped.append(cid)
                losses[cid] = loss
                self._refill(loop, r, clock)
                continue
            merged.append((delta, s_i, w))
            completed.append(cid)
            losses[cid] = loss
            staleness[cid] = stale
            # backfill the freed slot at the completion time
            self._refill(loop, r, clock)
        if merged:
            params, state = loop.get_model_fn()
            wsum = sum(w for _, _, w in merged)
            agg_delta = agg_state = None
            for delta, s_i, w in merged:
                # an f32 tensor times a Python float stays f32
                scaled = tree_map(lambda d: (w / wsum) * d, delta)
                ssc = tree_map(lambda s: (w / wsum) * s.float(), s_i)
                agg_delta = scaled if agg_delta is None else tree_map(
                    lambda a, b: a + b, agg_delta, scaled)
                agg_state = ssc if agg_state is None else tree_map(
                    lambda a, b: a + b, agg_state, ssc)
            new_p = tree_map(lambda p, d: (p.float() + d).to(p.dtype),
                             params, agg_delta)
            new_s = tree_map(lambda s, a: a.to(s.dtype), state, agg_state)
            loop.set_model_fn(new_p, new_s)
            st["version"] += 1
        return RoundRecord(r, completed, losses, dropped=dropped,
                           t_start=t0, duration=clock - t0, t_end=clock,
                           policy=self.name, staleness=staleness,
                           faults=faulted, retries=retries)

    def _dispatch(self, loop: "FederatedLoop", r: int, cid: int, now: float,
                  *, attempt: int = 0, times: Optional[Dict] = None,
                  base=None):
        """Push one in-flight entry, keyed by the earlier of its completion
        and its watchdog deadline. Its fault kind is drawn here, a retry's
        on the round index perturbed by ``7919 * attempt``; a hang
        completes at +inf."""
        st = loop.async_state
        if times is None:
            times = loop.times([cid], r)
        if base is None:
            base = loop.snapshot_fn()
        kind = None
        if loop.faults is not None:
            kind = loop.faults.schedule(
                [cid], r if attempt == 0 else r + 7919 * attempt).get(cid)
        t_fin = np.inf if kind == "hang" else now + times[cid]
        key = t_fin
        if self.timeout_s is not None:
            key = min(t_fin, now + self.timeout_s
                      * self.retry_backoff ** attempt)
        st["seq"] += 1
        heapq.heappush(st["in_flight"],
                       (key, st["seq"], cid, base[0], base[1],
                        st["version"], attempt, kind, t_fin))

    def _refill(self, loop: "FederatedLoop", r: int, now: float):
        st = loop.async_state
        while len(st["in_flight"]) < self.concurrency:
            busy = {e[2] for e in st["in_flight"]}
            avail = [c for c in loop.available(r) if c not in busy]
            if not avail:
                return
            sel = [c for c in loop.select_fn(r, avail) if c not in busy]
            sel = sel[:self.concurrency - len(st["in_flight"])]
            if not sel:
                return
            times = loop.times(sel, r)
            base = loop.snapshot_fn()
            for cid in sel:
                self._dispatch(loop, r, cid, now, times=times, base=base)


_POLICIES = {"sync": SyncAggregation, "deadline": DeadlineAggregation,
             "async": AsyncBufferedAggregation,
             "async-buffered": AsyncBufferedAggregation}


def resolve_policy(policy) -> Any:
    """'sync' | 'deadline' | 'async' | 'async-buffered' | a policy
    instance -> policy instance."""
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise ValueError(f"unknown aggregation policy {policy!r}; "
                             f"choose from {sorted(set(_POLICIES))}")
    return policy


@dataclass
class FederatedLoop:
    """Selection -> local training -> aggregation -> observation per tick.

    Hooks (closures over the trainer's own model state):

      select_fn(round_idx, available_ids) -> cohort ids
      train_fn(cohort, round_idx, *, sequential=None) -> {cid: mean loss};
          runs the round and applies the aggregate to the trainer's model;
          ``sequential`` forwards the deadline policy's escape hatch. With
          a ``faults`` injector the hook also gets ``faults={cid: kind}``
          on rounds where a corruption kind fired (and only then, so hooks
          without the argument run clean rounds)
      on_round(RoundRecord) -> truthy to stop (pace freeze, budget, ...)

    Async hooks (``AsyncBufferedAggregation`` only):

      snapshot_fn() -> (params, state), the current model's trees
      train_one_fn(cid, params, state, round_idx) -> (params_i, state_i, loss)
      get_model_fn() -> (params, state); set_model_fn(params, state)

    ``time_model=None`` builds the default ``|D_i| / c_i`` model from the
    fleet, or zero times with no fleet; ``availability=None`` makes every
    client available and drops nobody; ``faults=None`` injects nothing.
    """

    select_fn: Callable[[int, List[int]], List[int]] = None
    train_fn: Callable[..., Dict[int, float]] = None
    clients: Optional[Dict[int, Any]] = None
    client_ids: Optional[List[int]] = None
    aggregation: Union[str, Any] = "sync"
    time_model: Optional[FleetTimeModel] = None
    availability: Optional[AvailabilityTrace] = None
    faults: Optional[FaultInjector] = None
    on_round: Optional[Callable[[RoundRecord], Optional[bool]]] = None
    snapshot_fn: Optional[Callable] = None
    train_one_fn: Optional[Callable] = None
    get_model_fn: Optional[Callable] = None
    set_model_fn: Optional[Callable] = None
    clock: float = 0.0
    history: List[RoundRecord] = field(default_factory=list)
    async_state: Dict = field(default_factory=lambda: {
        "in_flight": [], "version": 0, "seq": 0})

    def __post_init__(self):
        self.aggregation = resolve_policy(self.aggregation)
        if self.client_ids is None:
            self.client_ids = sorted(self.clients) if self.clients else []
        if self.time_model is None and self.clients:
            self.time_model = FleetTimeModel.from_clients(self.clients)

    def available(self, round_idx: int) -> List[int]:
        if self.availability is None:
            return list(self.client_ids)
        return self.availability.available(self.client_ids, round_idx)

    def dropouts(self, cohort: Sequence[int], round_idx: int) -> List[int]:
        if self.availability is None:
            return []
        return self.availability.dropouts(cohort, round_idx)

    def times(self, cohort: Sequence[int], round_idx: int) -> Dict[int, float]:
        if self.time_model is None:
            return {int(c): 0.0 for c in cohort}
        return self.time_model.cohort_times(cohort, round_idx)

    def client_weight(self, cid: int) -> float:
        if self.clients and cid in self.clients:
            return float(self.clients[cid].num_samples)
        return 1.0

    def fault_schedule(self, cohort: Sequence[int],
                       round_idx: int) -> Dict[int, str]:
        """{cid: kind} from the ``FaultInjector`` ({} without one), for
        any subset of the fleet in any order."""
        if self.faults is None:
            return {}
        return self.faults.schedule(cohort, round_idx)

    def run_train(self, cohort: Sequence[int], round_idx: int, *,
                  schedule: Optional[Dict[int, str]] = None,
                  **kw) -> Tuple[Dict[int, float], List[int]]:
        """Train ``cohort`` through ``train_fn``, forwarding ``kw``
        (``sequential``), under this round's fault ``schedule`` (drawn
        when None): crashed and hung clients lose their update and come
        back as the ``crashed`` list, the corruption kinds go to the hook
        as ``faults=...`` when there are any. Returns ({cid: loss},
        crashed); nobody left trains nothing."""
        cohort = list(cohort)
        sched = (self.fault_schedule(cohort, round_idx) if schedule is None
                 else schedule)
        crashed = [c for c in cohort if sched.get(c) in ("crash", "hang")]
        live = [c for c in cohort if sched.get(c) not in ("crash", "hang")]
        if not live:
            return {}, crashed
        corrupt = {c: k for c, k in sched.items()
                   if k in CORRUPT_KINDS and c in set(live)}
        if corrupt:
            kw = dict(kw, faults=corrupt)
        return self.train_fn(live, round_idx, **kw), crashed

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


# ---------------------------------------------------------------------------
# Checkpoint/resume helpers (arrays only, CheckpointManager-ready)
# ---------------------------------------------------------------------------


def pack_rng_state(rs: np.random.RandomState) -> Dict[str, np.ndarray]:
    """A numpy RandomState stream as checkpointable arrays."""
    name, keys, pos, has_gauss, cached = rs.get_state()
    assert name == "MT19937"
    return {"keys": np.asarray(keys, np.uint32),
            "pos": np.asarray([pos, has_gauss], np.int64),
            "gauss": np.asarray([cached], np.float64)}


def unpack_rng_state(tree: Dict[str, np.ndarray]) -> np.random.RandomState:
    rs = np.random.RandomState(0)
    pos, has_gauss = (int(x) for x in np.asarray(tree["pos"]))
    rs.set_state(("MT19937", np.asarray(tree["keys"], np.uint32), pos,
                  has_gauss, float(np.asarray(tree["gauss"])[0])))
    return rs


def selector_state_tree(selector) -> Dict[str, np.ndarray]:
    """A selector's state: fitted communities (ragged -> flat + offsets),
    the epsilon-greedy bandit's utility and recency tables and its round
    counter, which keys the per-round ``mix_seed`` streams. A selector
    with its own ``state_dict`` serializes through it."""
    if hasattr(selector, "state_dict"):
        return selector.state_dict()
    t: Dict[str, np.ndarray] = {}
    comms = getattr(selector, "_communities", None)
    if comms:
        ragged = pack_ragged(comms)
        t["comm_flat"], t["comm_offsets"] = ragged["flat"], ragged["offsets"]
    bandit = getattr(selector, "_bandit", None)
    if bandit is not None:
        ids = sorted(bandit._util)
        t["bandit_ids"] = np.asarray(ids, np.int64)
        t["bandit_util"] = np.asarray([bandit._util[i] for i in ids],
                                      np.float64)
        t["bandit_seen"] = np.asarray(
            [bandit._last_seen.get(i, -1) for i in ids], np.int64)
        t["bandit_round"] = np.asarray([bandit._round], np.int64)
    if hasattr(selector, "_round"):
        t["round"] = np.asarray([selector._round], np.int64)
    return t


def load_selector_state(selector, tree: Dict[str, np.ndarray]) -> None:
    if hasattr(selector, "load_state_dict"):
        selector.load_state_dict(tree)
        return
    if "comm_flat" in tree:
        selector._communities = unpack_ragged(
            {"flat": tree["comm_flat"], "offsets": tree["comm_offsets"]})
    bandit = getattr(selector, "_bandit", None)
    if bandit is not None and "bandit_ids" in tree:
        ids = [int(i) for i in np.asarray(tree["bandit_ids"])]
        bandit._util = {i: float(u) for i, u in
                        zip(ids, np.asarray(tree["bandit_util"]))}
        bandit._last_seen = {i: int(s) for i, s in
                             zip(ids, np.asarray(tree["bandit_seen"]))
                             if int(s) >= 0}
        bandit._round = int(np.asarray(tree["bandit_round"])[0])
    if hasattr(selector, "_round") and "round" in tree:
        selector._round = int(np.asarray(tree["round"])[0])


def pack_float_map(d: Dict[int, float]) -> Dict[str, np.ndarray]:
    ids = sorted(d)
    return {"ids": np.asarray(ids, np.int64),
            "vals": np.asarray([d[i] for i in ids], np.float64)}


def unpack_float_map(tree: Dict[str, np.ndarray]) -> Dict[int, float]:
    return {int(i): float(v) for i, v in
            zip(np.asarray(tree["ids"]), np.asarray(tree["vals"]))}


def tree_like(template, restored):
    """A restored tree (numpy arrays, or bf16 CPU tensors) cast onto the
    structure, dtypes and devices of a live template of tensors. An empty
    subtree of the template holds no leaf, so a checkpoint has none."""
    if isinstance(template, dict):
        return {k: tree_like(v, restored.get(k, {}))
                for k, v in template.items()}
    return torch.as_tensor(restored).to(device=template.device,
                                        dtype=template.dtype)
