"""Population-scale participant selection as tensor programs on the card
(counterpart of ``repro/core/selector/vectorized.py``).

The list-based ``ParticipantSelector`` (selection.py) walks Python lists and
dicts per round — O(N) interpreter work plus an O(N^2) community/pool walk —
which caps the simulator at a few thousand clients. This module runs the
same per-stage policy (paper §IV-C, Eqs. 11-14) over a ``ClientPopulation``
structure-of-arrays, so the per-round control path is a handful of O(N)
tensor passes on the population's device:

  Eq. 12 memory filter      ``memory_bytes >= mem_required`` mask
  Eq. 14 feasibility        masked sum of the eligibility mask
  Eq. 11 utility            ``loss_sum - lam * stage_time`` (vectorized)
  community coverage        per-community eligible counts (``scatter_add``)
  within-community pick     gumbel-top-k: utility perturbed by Gumbel noise
                            scaled by ``epsilon``; per-community maxima via
                            ``scatter_reduce("amax")`` + lowest-index
                            ``scatter_reduce("amin")`` tie-break, one pass
                            per round-robin sweep

Round-robin coverage itself (which community contributes the next slot,
including the list path's pool-exhaustion re-permutes) depends only on the
per-community eligible COUNTS, never on which members win — so it runs as an
O(C) host simulation sharing the exact ``numpy.random.RandomState`` stream
of the list selector, while all O(N) member-level work stays on the device.

Bit-level agreement with the reference:
  * the columns are f32 (memory, capability, loss) and i32 (samples,
    community, ``last_seen``), cast once from the host's f64, and Eq. 11
    is rounded once (``time_model.fma32``), as XLA contracts it, so at
    ``epsilon=0`` the picks equal the reference's bit for bit, and the
    list selector's up to f32 utility resolution (two clients whose Eq. 11
    utilities differ by less than f32 epsilon tie, and the lower index
    wins);
  * the Gumbel noise is ``jax.random.gumbel``'s stream (``_threefry``),
    so ``epsilon>0`` picks follow the reference's except where two scores
    in a community lie within a few ulps: the masked mean and variance
    are f32 sums in another order;
  * every top-k is stable (equal scores resolve to the lower index, as
    ``lax.top_k`` does).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.selector import _threefry
from repro_torch.core.selector.bandit import mix_seed
from repro_torch.core.selector.selection import (ClientInfo,
                                                 InfeasibleStageError,
                                                 ParticipantSelector)
from repro_torch.core.time_model import fma32, stage_times_vec


def _f32(x, device) -> torch.Tensor:
    """Values (host f64 floats, arrays or tensors) cast once to f32 on
    ``device``."""
    return torch.as_tensor(x, dtype=torch.float32).to(device)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Structure-of-arrays population
# ---------------------------------------------------------------------------


@dataclass
class ClientPopulation:
    """Fleet state as device-resident tensors (one row per client).

    ``client_ids`` stays on host (external identity only); every per-round
    quantity the selector reads is a tensor on one device, so selection
    never walks a Python list. ``community_id`` is in ``[0, n_communities]``
    where the value ``n_communities`` is the "unassigned" bucket — mirrored
    from the list path, where clients outside every fitted community are
    never picked by the community round-robin.
    """

    client_ids: np.ndarray               # [N] host-side external ids
    memory_bytes: torch.Tensor           # [N] f32 — device memory capacity
    capability: torch.Tensor             # [N] f32 — c_i (FLOP/s)
    num_samples: torch.Tensor            # [N] i32 — |D_i|
    loss_sum: torch.Tensor               # [N] f32 — I_{t,i} (Eq. 9)
    community_id: torch.Tensor = None    # [N] i32
    n_communities: int = 1
    last_seen: torch.Tensor = None       # [N] i32 round last selected (-1)
    ef_residual_norm: torch.Tensor = None  # [N] f32 error-feedback norms
    _stage_time: Optional[tuple] = field(default=None, repr=False)

    def __post_init__(self):
        n, dev = self.n, self.device
        if self.community_id is None:
            self.community_id = torch.zeros(n, dtype=torch.int32, device=dev)
        if self.last_seen is None:
            self.last_seen = torch.full((n,), -1, dtype=torch.int32,
                                        device=dev)
        if self.ef_residual_norm is None:
            self.ef_residual_norm = torch.zeros(n, dtype=torch.float32,
                                                device=dev)

    @property
    def n(self) -> int:
        return len(self.client_ids)

    @property
    def device(self) -> torch.device:
        return self.memory_bytes.device

    @classmethod
    def from_infos(cls, infos, *, community_id=None, n_communities: int = 1,
                   device="cuda") -> "ClientPopulation":
        """Build on ``device`` from ``{cid: ClientInfo}`` (sorted by client
        id, so array index order matches the list selector's
        sorted-community pool order and tie-breaks agree) or a sequence
        (order preserved — callers that need a specific candidate order,
        e.g. the adapter mirroring the bandit's insertion-order semantics,
        pass a pre-ordered list)."""
        dev = resolve_device(device)
        if isinstance(infos, dict):
            infos = [infos[c] for c in sorted(infos)]
        else:
            infos = list(infos)
        return cls(
            client_ids=np.asarray([c.client_id for c in infos]),
            memory_bytes=_f32([c.memory_bytes for c in infos], dev),
            capability=_f32([c.capability for c in infos], dev),
            num_samples=_i32([c.num_samples for c in infos], dev),
            loss_sum=_f32([c.loss_sum for c in infos], dev),
            community_id=(None if community_id is None
                          else _i32(community_id, dev)),
            n_communities=n_communities)

    def shard(self, mesh) -> "ClientPopulation":
        """Placing the columns along a client mesh is not ported yet."""
        raise TypeError(
            "ClientPopulation.shard(mesh) is not ported yet: the client-axis "
            "mesh comes with ROADMAP item A14")

    def stage_time(self, flops_per_sample: float = 1.0, rho: float = 1.0
                   ) -> torch.Tensor:
        """Eq. 6 over the population via the shared vectorized time kernel
        (``core.time_model.stage_times_vec``); the default unit-FLOPs form
        is the selection heuristic t_t^i = |D_i| / c_i. Memoized on the
        device per (flops_per_sample, rho)."""
        key = (float(flops_per_sample), float(rho))
        if self._stage_time is None or self._stage_time[0] != key:
            self._stage_time = (key, stage_times_vec(
                np.float32(flops_per_sample), self.num_samples,
                self.capability, np.float32(rho)))
        return self._stage_time[1]

    def set_communities(self, community_id, n_communities: int):
        self.community_id = _i32(community_id, self.device)
        self.n_communities = int(n_communities)

    def update_loss_sums(self, idx, values):
        """Scatter fresh I_{t,i} for the clients trained this round (into a
        new tensor, as the reference's ``.at[].set``)."""
        rows = torch.as_tensor(idx).to(device=self.device, dtype=torch.long)
        self.loss_sum = self.loss_sum.index_put(
            (rows,), _f32(values, self.device))


# ---------------------------------------------------------------------------
# Tensor passes (all O(N) but the single-community top-k; see the module
# docstring for what matches the reference bit for bit)
# ---------------------------------------------------------------------------


def _population_stats(memory_bytes, stage_time, loss_sum, community_id,
                      gumbel, mem_required, lam, tau, *, n_comm):
    """Eqs. 11/12/14 + per-community coverage counts.

    Returns (score, elig, per-community eligible counts, n_eligible) where
    ``score`` is the (optionally Gumbel-perturbed) utility, ``-inf`` on
    ineligible rows. ``tau = epsilon * temperature``; the noise is scaled by
    the masked utility std so exploration strength is unit-free. The f32
    scalars ``mem_required``, ``lam`` and ``tau`` are 0-d tensors.
    """
    elig = memory_bytes >= mem_required                          # Eq. 12
    util = fma32(-lam, stage_time, loss_sum)                     # Eq. 11
    n_elig = elig.sum()
    n_e = torch.clamp_min(n_elig, 1).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=util.device)
    mu = torch.where(elig, util, zero).sum() / n_e
    var = torch.where(elig, (util - mu) ** 2, zero).sum() / n_e
    score = fma32(tau * torch.sqrt(var + 1e-12), gumbel, util)
    score = torch.where(elig, score, torch.full_like(score, -torch.inf))
    counts = torch.zeros(n_comm, dtype=torch.int64, device=util.device
                         ).scatter_add_(0, community_id.long(), elig.long())
    return score, elig, counts, n_elig                           # Eq. 14


def _quota_pick(score, community_id, quotas, qmax: int, *, n_comm):
    """Pick the top-``quotas[c]`` members of every community by score.

    One sweep per rank level: ``amax`` finds each community's current best,
    ``amin`` over indices breaks score ties toward the lowest index (== the
    list selector's stable pool order), winners are masked to ``-inf`` and
    the sweep repeats, ``qmax = max(quotas)`` times on the host (an empty
    community keeps ``-inf`` and the index ``n``, as JAX's segment ops
    do). O(N * qmax) with no sort.

    Returns (picked mask [N], sweep index each pick happened at [N]).
    """
    n = score.shape[0]
    dev = score.device
    idx = torch.arange(n, device=dev)
    cid = community_id.long()
    quota_of = quotas[cid]
    sc = score
    picked = torch.zeros(n, dtype=torch.bool, device=dev)
    sweep_of = torch.full((n,), -1, dtype=torch.int32, device=dev)
    neg_inf = torch.full_like(sc, -torch.inf)
    for t in range(qmax):
        seg_best = torch.full((n_comm,), -torch.inf, device=dev
                              ).scatter_reduce(0, cid, sc, "amax",
                                               include_self=True)
        live = (sc == seg_best[cid]) & (quota_of > t) & torch.isfinite(sc)
        winner = torch.full((n_comm,), n, device=dev).scatter_reduce(
            0, cid, torch.where(live, idx, n), "amin", include_self=True)
        is_winner = live & (winner[cid] == idx)
        sc = torch.where(is_winner, neg_inf, sc)
        picked |= is_winner
        sweep_of = torch.where(is_winner, t, sweep_of)
    return picked, sweep_of


def _topk_pick(score, *, k):
    """Single-community fast path: top-k by a stable sort (equal scores
    resolve to the lower index, as ``lax.top_k`` and the list bandit's
    sort do)."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return idx[:k], torch.isfinite(vals[:k])


def _mask_to_community(score, community_id):
    """Silence rows outside community 0 (i.e. the unassigned bucket when a
    single community is fitted)."""
    return torch.where(community_id == 0, score,
                       torch.full_like(score, -torch.inf))


def _tier_admission(memory_bytes, stage_bytes, tier_cache_bytes):
    """Eq. 12 run once per feature-cache tier, vectorized: ``fits[t, i]``
    iff client i's memory covers the stage requirement plus its shard's
    cache at ladder tier t. Returns [N] i32 — the FIRST (most exact) tier
    that fits, -1 when even the smallest tier is declined."""
    fits = memory_bytes[None, :] >= stage_bytes + tier_cache_bytes
    n_tiers = fits.shape[0]
    # rank T for tier 0 down to 1 for the last: the largest fitting rank
    # is the first tier that fits, 0 where none does
    rank = torch.arange(n_tiers, 0, -1, device=fits.device)[:, None]
    best = (fits.long() * rank).amax(0)
    return torch.where(best > 0, n_tiers - best, -1).to(torch.int32)


def assign_cache_tiers(pop: "ClientPopulation", stage_bytes: float,
                       per_sample_bytes: Sequence[float]) -> np.ndarray:
    """Population-scale feature-cache admission ladder (the vectorized twin
    of ``SmartFreezeServer._cache_plan`` / ``memory_model.cache_tier_ladder``).

    ``per_sample_bytes[t]`` is the cache cost per local sample at ladder
    tier t (cache bytes are linear in shard size, int8 scale vectors
    included, so the per-sample rate is exact). One O(T*N) pass on the
    population's device; returns an [N] host array of ladder indices (-1 =
    cache declined)."""
    dev = pop.device
    rates = torch.from_numpy(np.asarray(per_sample_bytes, np.float32)
                             ).to(dev)[:, None]
    cache = rates * pop.num_samples.to(torch.float32)[None, :]
    stage = torch.tensor(np.float32(stage_bytes), device=dev)
    return _tier_admission(pop.memory_bytes, stage, cache).cpu().numpy()


# ---------------------------------------------------------------------------
# Host-side round-robin quota simulation (exact list-path mirror)
# ---------------------------------------------------------------------------


def _roundrobin_quotas(sizes: np.ndarray, k: int, rng) -> tuple:
    """Replay ``ParticipantSelector.select``'s community round-robin on pool
    SIZES only (O(C + k) host work). Which community fills each slot depends
    only on eligible counts and the RandomState stream, never on member
    identity — so this reproduces the list path's pick schedule exactly,
    including mid-draw pool-exhaustion re-permutes.

    Returns (quota per pool [len(sizes)], pick schedule [(pool, rank), ...]).
    """
    total_avail = int(sizes.sum())
    k_eff = min(k, total_avail)
    pools = [i for i in range(len(sizes)) if sizes[i] > 0]
    taken = np.zeros(len(sizes), np.int64)
    order = rng.permutation(len(pools)) if pools else np.empty(0, np.int64)
    schedule: List[tuple] = []
    ci = 0
    while len(schedule) < k_eff and pools:
        pool = pools[order[ci % len(pools)] % len(pools)]
        if taken[pool] < sizes[pool]:
            schedule.append((pool, int(taken[pool])))
            taken[pool] += 1
        else:
            pools = [p for p in pools if taken[p] < sizes[p]]
            order = rng.permutation(len(pools)) if pools else order
        ci += 1
    return taken, schedule


# ---------------------------------------------------------------------------
# Selector
# ---------------------------------------------------------------------------


@dataclass
class VectorizedSelector:
    """Drop-in ``ParticipantSelector`` replacement backed by tensor passes
    on ``device`` (the card unless the caller asks for the CPU).

    Two entry points:

      * ``select(clients_dict, k, mem_required=..., stage_time_fn=...)`` —
        the list-selector contract (used by ``SmartFreezeServer``): builds a
        throwaway ``ClientPopulation`` on ``device`` per call. With
        ``epsilon=0`` it returns the picks of ``ParticipantSelector`` for
        the same seed; use it as the small-N cross-check.
      * ``select_arrays(population, k, mem_required=..., round_idx=...)`` —
        the population-scale hot path: tensors stay resident on the
        population's device across rounds, each call costs a few O(N)
        passes plus an O(C) host quota replay.

    ``phi`` gates Eq. 14 feasibility exactly like the list path (raises
    ``InfeasibleStageError`` on the memory-eligible count, before community
    assignment is consulted).
    """

    lam: float = 1e-3                 # lambda in Eq. 11
    epsilon: float = 0.2
    phi: int = 2                      # Eq. 14 minimum eligible clients
    seed: int = 0
    temperature: float = 1.0          # gumbel-top-k softness (eps>0 only)
    device: str = "cuda"
    _round: int = 0
    _communities: Optional[List[List[int]]] = None

    # ----- setup -----

    def fit_communities(self, similarity: np.ndarray) -> List[List[int]]:
        """Small-N oracle path: dense RL-CD, same as the list selector."""
        from repro_torch.core.selector.rlcd import rlcd_communities
        self._communities = rlcd_communities(np.asarray(similarity),
                                             seed=self.seed)
        return self._communities

    def fit_communities_sketch(self, label_histograms: np.ndarray, *,
                               sketch_dim: int = 64, num_neighbors: int = 8,
                               n_iter: int = 30, block_rows: int = 4096
                               ) -> np.ndarray:
        """Population-scale path: hashed label-distribution sketches + tiled
        similarity + vectorized label propagation (see rlcd.py) on
        ``device``. Returns the per-row community id array (pass it to
        ``ClientPopulation.set_communities`` for ``select_arrays``)."""
        from repro_torch.core.selector.rlcd import sketch_communities
        comm_id, n_comm = sketch_communities(
            label_histograms, sketch_dim=sketch_dim,
            num_neighbors=num_neighbors, n_iter=n_iter, seed=self.seed,
            block_rows=block_rows, device=self.device)
        self._communities = [np.flatnonzero(comm_id == c).tolist()
                             for c in range(n_comm)]
        return comm_id

    # ----- checkpoint/resume (fl/sim.py serializes through these) -----

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Round counter + fitted communities as arrays — everything a
        resumed run needs to continue the per-round ``mix_seed`` RNG streams
        and community round-robin pick-identically. The reference's
        selector writes the same keys."""
        from repro_torch.checkpoint.ckpt import pack_ragged
        out: Dict[str, np.ndarray] = {"round": np.asarray([self._round],
                                                          np.int64)}
        if self._communities:
            ragged = pack_ragged(self._communities)
            out["comm_flat"] = ragged["flat"]
            out["comm_offsets"] = ragged["offsets"]
        return out

    def load_state_dict(self, state: Dict[str, np.ndarray]) -> None:
        from repro_torch.checkpoint.ckpt import unpack_ragged
        self._round = int(np.asarray(state["round"])[0])
        if "comm_flat" in state:
            self._communities = unpack_ragged(
                {"flat": state["comm_flat"],
                 "offsets": state["comm_offsets"]})

    # ----- feature-cache tier admission (Eq. 12 per tier) -----

    def cache_admission(self, pop: ClientPopulation, *, stage_bytes: float,
                        per_sample_bytes: Sequence[float],
                        tiers: Sequence[str] = ("f32", "fp16", "int8")
                        ) -> Dict[int, Optional[str]]:
        """Tier granted per client id (None = recompute): the vectorized
        form of the server's admission ladder, one pass over the resident
        population instead of an O(N) host walk. ``per_sample_bytes`` and
        ``tiers`` align (most exact first)."""
        idx = assign_cache_tiers(pop, stage_bytes, per_sample_bytes)
        return {int(cid): (tiers[i] if i >= 0 else None)
                for cid, i in zip(pop.client_ids, idx)}

    # ----- population-scale hot path -----

    def select_arrays(self, pop: ClientPopulation, k: int, *,
                      mem_required: float, round_idx: Optional[int] = None,
                      stage_time: Optional[torch.Tensor] = None,
                      round_robin: Optional[bool] = None) -> np.ndarray:
        """One round of selection over a resident population.

        Returns row indices into ``pop`` in pick order. Host syncs: the
        eligible count and the [C]-sized eligible counts (for the quota
        replay), and the final picks.

        ``round_robin`` forces the community round-robin schedule even for a
        single fitted community (the list path's behavior whenever
        ``fit_communities`` ran); the default uses it iff ``n_communities >
        1`` and otherwise mirrors the bandit fast path — top-k by score,
        except that ``k >= #eligible`` returns every eligible client in
        ascending index order (``UtilBandit.pick``'s early return).
        """
        # the internal round counter is committed only AFTER the Eq. 14
        # feasibility check: the list selector raises before its bandit's
        # next_round(), so a caught InfeasibleStageError must not
        # desynchronize the two implementations' RNG streams
        commit_round = round_idx is None
        if commit_round:
            round_idx = self._round
        n, n_comm = pop.n, pop.n_communities
        dev = pop.device
        tau = float(self.epsilon) * float(self.temperature)
        if self.epsilon > 0:
            gumbel = _threefry.gumbel(mix_seed(self.seed, round_idx + 1), n,
                                      dev)
        else:
            gumbel = torch.zeros(n, dtype=torch.float32, device=dev)
        scalar = lambda v: torch.tensor(np.float32(v), device=dev)
        # community ids may include the "unassigned" bucket n_comm
        score, _, counts, n_elig = _population_stats(
            pop.memory_bytes,
            pop.stage_time() if stage_time is None else stage_time,
            pop.loss_sum, pop.community_id, gumbel, scalar(mem_required),
            scalar(self.lam), scalar(tau), n_comm=n_comm + 1)
        n_elig = int(n_elig)                      # host sync #1 (Eq. 14)
        if n_elig < self.phi:
            raise InfeasibleStageError(
                f"only {n_elig} clients fit {mem_required / 2**20:.0f} MiB "
                f"(phi={self.phi}) — repartition blocks or lower batch size")
        if commit_round:
            self._round += 1
        sizes = counts.cpu().numpy()[:n_comm]     # unassigned bucket excluded
        rng = np.random.RandomState(mix_seed(self.seed, round_idx + 1))
        if round_robin is None:
            round_robin = n_comm > 1
        if n_comm == 1 and not round_robin:
            # no communities fitted: the bandit fast path. The unassigned
            # bucket cannot exist here, but mask it anyway for safety.
            k_eff = min(k, int(sizes[0]))
            if k_eff == 0:
                return np.empty(0, np.int64)
            in_comm = _mask_to_community(score, pop.community_id)
            idx, valid = _topk_pick(in_comm, k=min(k, n))
            sel = idx.cpu().numpy()[valid.cpu().numpy()][:k_eff]
            if k_eff == int(sizes[0]):
                # k covers every eligible client: the list path's
                # ``bandit.pick`` early-returns the candidates in their
                # original (ascending-index) order, not by score
                sel = np.sort(sel)
            sel = sel.astype(np.int64)
            self._mark_seen(pop, sel, round_idx)
            return sel
        quotas, schedule = _roundrobin_quotas(sizes, k, rng)
        if not schedule:
            return np.empty(0, np.int64)
        quotas_dev = _i32(np.concatenate([quotas, [0]]), dev)
        picked, sweep_of = _quota_pick(score, pop.community_id, quotas_dev,
                                       int(quotas.max()), n_comm=n_comm + 1)
        rows = torch.nonzero(picked).flatten()    # host sync #2 (the picks)
        rows_h, comm_h, sweep_h = torch.stack(
            [rows, pop.community_id[rows].long(), sweep_of[rows].long()]
        ).cpu().numpy()
        by_slot = {(int(c), int(t)): int(i)
                   for i, c, t in zip(rows_h, comm_h, sweep_h)}
        sel = np.asarray([by_slot[(c, t)] for c, t in schedule], np.int64)
        self._mark_seen(pop, sel, round_idx)
        return sel

    @staticmethod
    def _mark_seen(pop: ClientPopulation, sel: np.ndarray, round_idx: int):
        pop.last_seen = pop.last_seen.index_put(
            (torch.as_tensor(sel, device=pop.device),),
            torch.tensor(round_idx, dtype=torch.int32, device=pop.device))

    # ----- list-selector-compatible adapter (small-N reference contract) ---

    def select(self, clients: Dict[int, ClientInfo], k: int, *,
               mem_required: float, stage_time_fn) -> List[int]:
        # candidate order mirrors the list path's two regimes: with fitted
        # communities the bandit sees sorted pool members, without them it
        # sees the clients dict in insertion order (tie-breaks and the
        # k >= #eligible early return follow that order)
        ids = sorted(clients) if self._communities else list(clients)
        infos = [clients[c] for c in ids]
        n_comm = 1
        community_id = None
        if self._communities:
            n_comm = len(self._communities)
            by_id = {cid: c for c, comm in enumerate(self._communities)
                     for cid in comm}
            community_id = [by_id.get(cid, n_comm) for cid in ids]
        pop = ClientPopulation.from_infos(
            infos, community_id=community_id, n_communities=n_comm,
            device=self.device)
        stage_time = _f32([stage_time_fn(c) for c in infos], pop.device)
        sel = self.select_arrays(pop, k, mem_required=mem_required,
                                 stage_time=stage_time,
                                 round_robin=self._communities is not None)
        return [ids[i] for i in sel]


def population_from_selector(selector: ParticipantSelector,
                             infos: Dict[int, ClientInfo], *,
                             device="cuda") -> ClientPopulation:
    """Convenience: snapshot a list-selector's world into tensors on
    ``device`` (communities included) — used by tests and the chip smoke."""
    comms = selector._communities or [sorted(infos)]
    ids = sorted(infos)
    by_id = {cid: c for c, comm in enumerate(comms) for cid in comm}
    community_id = [by_id.get(cid, len(comms)) for cid in ids]
    return ClientPopulation.from_infos(
        infos, community_id=community_id, n_communities=len(comms),
        device=device)
