"""SmartFreeze server for the CNN testbed and the vanilla FedAvg baseline
(counterpart of ``repro/fl/server.py:SmartFreezeServer`` and
``FedAvgServer``).

``run`` executes the paper's pipeline end to end:
  (1) split the model into T stages and bootstrap the Eq. 8 client
      similarity from one-shot output-layer gradients;
  (2) fit RL-CD communities;
  (3) per stage: participant selection (Eq. 11-14) -> local training ->
      Eq. 1 aggregation (compressed uplinks folded by the CUDA kernel) ->
      the pace controller observes the block perturbation and freezes the
      stage when it has converged;
  (4) grow the model until every stage is trained.

The feature cache is admitted per client and stage by the memory model's
ladder over ``cache_tiers`` (f32 -> fp16 -> int8 with ``"all"``), and
``compute_dtype="bfloat16"`` trains every stage's clients in bf16 with f32
master weights (``fl/engine.py``, ``fl/quant.py``).

Rounds run under the sync, deadline (``deadline_factor > 0``, or
``aggregation="deadline"``) or async-buffered policy (``fl/sim.py``),
over an optional ``AvailabilityTrace``; ``fused=False`` sends every round
to the engine's sequential escape hatch.

Defenses: ``faults`` (a ``fl/faults.FaultInjector``) goes to the loop,
``screen_updates`` and ``aggregator`` to every stage's engine, and
``freeze_rollback`` watches the rounds after each pace freeze: when the
mean loss stays above the pre-freeze reference plus ``rollback_guard``
for ``rollback_patience`` rounds, the freeze is undone and the frozen
stage restarts from its freeze-time snapshot, at most ``max_rollbacks``
times a run. ``RoundResult`` records the screened clients and the
rollback.

``FedAvgServer`` trains the full model every round over a random cohort
of the clients whose memory holds it, on the same loop and with the same
policy, availability, ``fused``, ``compress_ratio``, ``compute_dtype``,
``faults``, ``screen_updates`` and ``aggregator`` knobs.

Checkpoint and resume ride on ``checkpoint.CheckpointManager``
(``run(..., ckpt_manager=..., ckpt_every=N, resume=True)``): every N
rounds and at pace freezes the stage base, the active tree, BN state, the
pace controller's window, the selector and its bandit, the ``_last_loss``
table, the error-feedback residual pools, the feature cache (when it
changed since the last save) and the virtual clock are saved, so a
resumed run continues bit for bit, across stage freezes and cache-tier
decisions alike, under the sync and deadline policies. The rollback's
armed state and the async-buffered policy's in-flight clients are not
saved, as in the reference. ``FedAvgServer`` saves its params, BN state,
residual pools and selection stream.

``selector`` accepts either the list-based ``ParticipantSelector`` or the
population-scale ``core.selector.vectorized.VectorizedSelector`` (on its
own ``device``, the card unless asked otherwise) — both implement
``fit_communities`` + ``select`` with the same contract, and both
checkpoint through ``fl/sim.py:selector_state_tree``.

Not ported yet, and rejected with ``TypeError`` rather than ignored:
``mesh`` and ``use_pallas``. The compressed fold always goes through
``kernels.ops.sparse_cohort_add``: a CUDA launch on the card, the plain
version on the CPU.
"""
from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import freezing_cnn as fz
from repro_torch.core.memory_model import (CACHE_TIER_DTYPES, CACHE_TIERS,
                                           cache_tier_ladder,
                                           cnn_stage_memory_bytes)
from repro_torch.core.pace import PaceController
from repro_torch.core.selector import (InfeasibleStageError,
                                       ParticipantSelector)
from repro_torch.core.selector.similarity import similarity_matrix
from repro_torch.core.time_model import cnn_cached_compute_scale
from repro_torch.fl.client import SimClient
from repro_torch.fl.engine import AGGREGATORS, RoundEngine
from repro_torch.fl.faults import FaultInjector
from repro_torch.fl.sim import (AvailabilityTrace, DeadlineAggregation,
                                FederatedLoop, FleetTimeModel,
                                SyncAggregation, load_selector_state,
                                pack_float_map, pack_rng_state,
                                resolve_policy, selector_state_tree,
                                tree_like, unpack_float_map,
                                unpack_rng_state)
from repro_torch.models.cnn import CNN
from repro_torch.models.module import tree_leaves
from repro_torch.optim import Optimizer, sgd

__all__ = ["FedAvgServer", "SmartFreezeServer", "RoundResult"]


@dataclass
class RoundResult:
    round_idx: int
    stage: int
    loss: float
    test_acc: Optional[float] = None
    selected: List[int] = field(default_factory=list)
    perturbation: Optional[float] = None
    frozen: bool = False
    uplink_bytes: Optional[int] = None   # cohort uplink payload this round
    duration: Optional[float] = None     # virtual seconds this round took
    virtual_time: Optional[float] = None  # virtual clock at round end
    dropped: List[int] = field(default_factory=list)  # late / dropout / retry
    cache_bytes: Optional[int] = None    # resident feature cache
    screened: List[int] = field(default_factory=list)  # updates screened out
    rolled_back: bool = False            # this round triggered a rollback


_log = logging.getLogger(__name__)


def _check_aggregator(aggregator: str):
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; "
                         f"choose from {AGGREGATORS}")


def _screened(engine: RoundEngine) -> List[int]:
    return sorted(c for c, s in engine.last_screened.items() if s)


def _mean_loss(losses: Dict[int, float],
               prev: Optional[float] = None) -> float:
    """Mean of the finite per-client losses this round. A starved round
    (empty cohort, or no finite loss) returns ``prev`` when available, so
    the history never ingests a NaN, and logs the starvation."""
    vals = [v for v in losses.values() if np.isfinite(v)]
    if vals:
        return float(np.mean(vals))
    _log.warning("starved round: %d client losses reported, none finite; "
                 "carrying previous loss %s", len(losses), prev)
    return float(prev) if prev is not None else float("nan")


class SmartFreezeServer:
    """``device`` defaults to the card and raises when CUDA is absent; the
    model's params must live there too."""

    def __init__(self, model: CNN, clients: List[SimClient], *,
                 optimizer_fn: Callable[[], Optimizer] = lambda: sgd(0.05),
                 clients_per_round: int = 10, local_epochs: int = 1,
                 batch_size: int = 32, rounds_per_stage: int = 60,
                 pace_kwargs: Optional[dict] = None,
                 op_kind: str = "conv",
                 selector: Optional[ParticipantSelector] = None,
                 deadline_factor: float = 0.0, seed: int = 0,
                 fused: bool = True, cache_features: bool = True,
                 cache_tiers: Union[str, tuple, list] = ("f32",),
                 compute_dtype: Optional[str] = None,
                 cache_time_scale: bool = False,
                 compress_ratio: Optional[float] = None,
                 aggregation: Union[str, object, None] = None,
                 time_model: Optional[FleetTimeModel] = None,
                 availability: Optional[AvailabilityTrace] = None,
                 screen_updates: bool = False, aggregator: str = "mean",
                 faults: Optional[FaultInjector] = None,
                 freeze_rollback: bool = False,
                 rollback_guard: float = 0.5, rollback_window: int = 8,
                 rollback_patience: int = 2, max_rollbacks: int = 1,
                 device="cuda"):
        _check_aggregator(aggregator)
        # admission ladder, most exact first; "all" is f32 -> fp16 -> int8
        self.cache_tiers = (CACHE_TIERS if cache_tiers == "all"
                            else tuple(cache_tiers))
        unknown = [t for t in self.cache_tiers if t not in CACHE_TIERS]
        if unknown:
            raise ValueError(f"unknown cache tiers {unknown}; "
                             f"choose from {CACHE_TIERS}")
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.model = model
        self.clients = {c.client_id: c for c in clients}
        self.optimizer_fn = optimizer_fn
        self.k = clients_per_round
        self.local_epochs = local_epochs
        self.batch_size = batch_size
        self.rounds_per_stage = rounds_per_stage
        self.pace_kwargs = pace_kwargs or {}
        self.op_kind = op_kind
        self.selector = selector or ParticipantSelector(seed=seed)
        self.deadline_factor = deadline_factor  # > 0: drop late stragglers
        self.seed = seed
        self.fused = fused
        self.cache_features = cache_features
        self.cache_time_scale = cache_time_scale
        self.compress_ratio = compress_ratio
        self.aggregation = aggregation
        self.policy = self._policy()
        self.time_model = time_model
        self.availability = availability
        self.screen_updates = screen_updates
        self.aggregator = aggregator
        self.faults = faults
        self.freeze_rollback = freeze_rollback
        self.rollback_guard = rollback_guard
        self.rollback_window = rollback_window
        self.rollback_patience = rollback_patience
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0                   # freeze rollbacks taken so far
        self.history: List[RoundResult] = []
        self.cache_tier_plan: Dict[int, Optional[str]] = {}  # current stage
        self._last_loss: Dict[int, float] = {}
        self.image_size = int(next(iter(self.clients.values())).data["x"].shape[1])

    def _policy(self):
        if self.aggregation is not None:
            return resolve_policy(self.aggregation)
        if self.deadline_factor > 0:
            return DeadlineAggregation(factor=self.deadline_factor)
        return SyncAggregation()

    # ----- bootstrap: similarity from output-layer gradients (Eq. 8) -----

    def bootstrap_similarity(self, params, state) -> np.ndarray:
        grads = {}
        for cid, c in self.clients.items():
            x = torch.as_tensor(c.data["x"][:64], device=self.device)
            y = torch.as_tensor(c.data["y"][:64], device=self.device)
            fc = {k: v.detach().requires_grad_(True)
                  for k, v in params["fc"].items()}
            logits, _ = self.model.apply({**params, "fc": fc}, state, x,
                                         train=False)
            lf = logits.float()
            gold = lf.gather(-1, y.long()[:, None])[:, 0]
            loss = torch.mean(torch.logsumexp(lf, dim=-1) - gold)
            g = torch.autograd.grad(loss, tree_leaves(fc))
            grads[cid] = torch.cat([t.reshape(-1) for t in g]).cpu().numpy()
        return similarity_matrix(grads)

    # ----- per-stage engine construction -----

    def _stage_engine(self, stage: int, frozen, bn_state) -> RoundEngine:
        model = self.model
        cached_loss = feature_fn = None
        if stage > 0:
            cached_loss = fz.cnn_cached_stage_loss_fn(model, stage,
                                                      op_kind=self.op_kind)
            feature_fn = (lambda x, _fr=frozen, _st=bn_state:
                          fz.cnn_prefix_features(model, _fr, _st, x, stage))
        return RoundEngine(
            loss_fn=fz.cnn_stage_loss_fn(model, stage, op_kind=self.op_kind),
            optimizer=self.optimizer_fn(), frozen=frozen,
            cached_loss_fn=cached_loss, feature_fn=feature_fn,
            batch_size=self.batch_size, local_epochs=self.local_epochs,
            clip_norm=10.0, fused=self.fused,
            compress_ratio=self.compress_ratio,
            compute_dtype=self.compute_dtype, device=self.device,
            screen=self.screen_updates, aggregator=self.aggregator)

    def _cache_plan(self, stage: int) -> Dict[int, Optional[str]]:
        """The memory model's admission ladder (Eq. 12 per tier): walk
        ``cache_tiers`` most exact first and grant each client the first
        tier whose stage requirement plus its shard's prefix activations at
        that tier's dtype fits its memory; ``None`` recomputes the
        prefix."""
        if not self.cache_features or stage == 0:
            return {}
        plan = {}
        for cid, c in self.clients.items():
            plan[cid] = cache_tier_ladder(
                c.memory_bytes,
                lambda t, _n=c.num_samples: cnn_stage_memory_bytes(
                    self.model, stage, self.batch_size, self.image_size,
                    cache_samples=_n, cache_dtype=CACHE_TIER_DTYPES[t]),
                tiers=self.cache_tiers)
        return plan

    # ----- main loop (one FederatedLoop per stage) -----

    def run(self, params, state, *, eval_fn: Optional[Callable] = None,
            eval_every: int = 10, total_rounds: Optional[int] = None,
            schedule: Optional[List[int]] = None, ckpt_manager=None,
            ckpt_every: int = 0, resume: bool = False) -> Dict:
        """schedule: optional fixed rounds per stage (pace-controller
        ablation). ``eval_fn(params, state, stage)`` runs every
        ``eval_every`` rounds and at pace freezes. ``ckpt_manager`` /
        ``ckpt_every``: save the experiment every N completed rounds and
        at freezes; ``resume=True`` restores the newest committed step and
        continues the loss, perturbation and selection series bit for
        bit."""
        model = self.model
        n_stages = len(model.cfg.stage_sizes)
        budget = total_rounds or self.rounds_per_stage * n_stages
        clock = 0.0
        round_idx = 0
        start_stage = 0
        restored = None
        if resume and ckpt_manager is not None:
            try:
                restored = ckpt_manager.restore()
            except FileNotFoundError:
                restored = None
        if restored is None:
            self.selector.fit_communities(
                self.bootstrap_similarity(params, state))
        else:
            tree, meta = restored["tree"], restored["metadata"]
            load_selector_state(self.selector, tree["selector"])
            self._last_loss = unpack_float_map(tree["last_loss"])
            params = tree_like(params, tree["params"])
            state = tree_like(state, tree["state"])
            clock = float(meta["clock"])
            round_idx = int(meta["round_idx"]) + 1
            start_stage = int(meta["stage"])

        # freeze rollback: armed right after a pace freeze with the merged
        # model and the pre-freeze loss reference; the next stage's rounds
        # are watched for a regression past the guard band. The armed
        # state is not saved: a resumed run arms at its next freeze
        rb_armed: Optional[Dict] = None
        recent_losses: List[float] = []
        stage = start_stage
        while stage < n_stages:
            # a restored mid-stage step, consumed by the stage it names
            mid = (restored["metadata"] if restored is not None
                   and stage == start_stage else None)
            if schedule is not None:
                plan_rounds = schedule[stage]
            elif mid is not None:
                plan_rounds = int(mid["plan_rounds"])
            else:
                # pace-adaptive budget: early freezes hand their unused
                # rounds to later stages (>= 1 round per remaining stage)
                plan_rounds = max(budget - round_idx - (n_stages - stage - 1), 1)
            pace = PaceController(**self.pace_kwargs)
            frozen, active = fz.init_cnn_stage_active(
                model, params, stage,
                torch.Generator().manual_seed(self.seed + stage),
                op_kind=self.op_kind)
            r_in_stage = 0
            if mid is not None:
                active = tree_like(active, restored["tree"]["active"])
                pace.load_state_dict(restored["tree"]["pace"])
                r_in_stage = int(mid["r_in_stage"]) + 1
            engine = self._stage_engine(stage, frozen, state)
            if mid is not None and "ef" in restored["tree"]:
                engine.load_ef_state(restored["tree"]["ef"])
            if mid is not None and "cache" in restored["tree"]:
                # the exact cached bytes (tiers and int8 scales) the
                # crashed run trained on
                engine.load_cache_state(restored["tree"]["cache"])
            cache_ok = self._cache_plan(stage)
            self.cache_tier_plan = cache_ok
            mem_req = cnn_stage_memory_bytes(model, stage, self.batch_size,
                                             self.image_size)
            stage_base = params
            box = {"active": active, "state": state}
            flags = {"freeze": False, "rollback": False}
            stage_done = mid is not None and (
                bool(mid.get("frozen")) or r_in_stage >= plan_rounds)
            time_fn = lambda ci: ci.num_samples / ci.capability

            def select_fn(r, avail):
                infos = {cid: dataclasses.replace(
                    self.clients[cid].info(),
                    loss_sum=(self._last_loss.get(cid, 1e3)
                              * self.clients[cid].num_samples))
                    for cid in avail}
                try:
                    # Eq. 11-14: I_{t,i} = |D_i| * latest local loss
                    return self.selector.select(infos, self.k,
                                                mem_required=mem_req,
                                                stage_time_fn=time_fn)
                except InfeasibleStageError:
                    if len(avail) < len(self.clients):
                        # an availability dip, not a memory-infeasible
                        # stage: skip the round (0.0 virtual seconds)
                        return []
                    raise

            def train_fn(cohort, r, sequential=None, faults=None):
                box["active"], box["state"], losses = engine.run_round(
                    self.clients, cohort, box["active"], box["state"], r,
                    use_cache=cache_ok, sequential=sequential, faults=faults)
                self._last_loss.update(
                    {c: v for c, v in losses.items() if np.isfinite(v)})
                return losses

            def train_one_fn(cid, p, s, r):
                p_i, s_i, losses = engine.run_round(
                    self.clients, [cid], p, s, r, use_cache=cache_ok,
                    sequential=True)
                self._last_loss.update(losses)
                return p_i, s_i, losses[cid]

            def set_model_fn(p, s):
                box["active"], box["state"] = p, s

            def on_round(rec):
                p = pace.observe(box["active"].get("stages", box["active"]))
                prev = self.history[-1].loss if self.history else None
                loss = _mean_loss(rec.losses, prev=prev)
                do_freeze = pace.should_freeze() and schedule is None
                # the watch armed by the previous stage's freeze: a
                # sustained regression past the guard band rolls it back
                rolled = False
                if rb_armed is not None and np.isfinite(loss):
                    if loss > rb_armed["ref"] + self.rollback_guard:
                        rb_armed["bad"] += 1
                    else:
                        rb_armed["bad"] = 0
                    if rb_armed["bad"] >= self.rollback_patience:
                        rolled = flags["rollback"] = True
                        do_freeze = False
                flags["freeze"] = do_freeze
                rr = RoundResult(rec.round_idx, stage, loss,
                                 selected=rec.selected, perturbation=p,
                                 frozen=do_freeze,
                                 uplink_bytes=engine.last_uplink_bytes,
                                 duration=rec.duration,
                                 virtual_time=rec.t_end,
                                 dropped=rec.dropped,
                                 cache_bytes=engine.cache_nbytes(),
                                 screened=_screened(engine),
                                 rolled_back=rolled)
                if np.isfinite(loss):
                    recent_losses.append(loss)
                    del recent_losses[:-self.rollback_window]
                if eval_fn is not None and (rec.round_idx % eval_every == 0
                                            or do_freeze):
                    merged = fz.merge_cnn_params(model, stage_base, stage,
                                                 box["active"])
                    rr.test_acc = eval_fn(merged, box["state"], stage)
                self.history.append(rr)
                if ckpt_manager is not None and ckpt_every and (
                        (rec.round_idx + 1) % ckpt_every == 0
                        or do_freeze):
                    self._save_ckpt(
                        ckpt_manager, rec, stage, stage_base, box, pace,
                        engine, plan_rounds,
                        rec.round_idx - round_idx + r_in_stage, do_freeze)
                return do_freeze or rolled

            # copy before stamping the stage payload: a caller's time
            # model may be shared across runs
            tm = (dataclasses.replace(self.time_model)
                  if self.time_model is not None
                  else FleetTimeModel.from_clients(self.clients))
            tm.payload_bytes = engine.per_client_uplink_bytes(active)
            if self.cache_time_scale:
                scale_of = {cid: cnn_cached_compute_scale(stage)
                            for cid, t in cache_ok.items() if t}
                if scale_of:
                    tm = tm.with_compute_scale(scale_of)
            loop = FederatedLoop(
                select_fn=select_fn, train_fn=train_fn, clients=self.clients,
                client_ids=list(self.clients), aggregation=self.policy,
                time_model=tm, availability=self.availability,
                faults=self.faults, on_round=on_round,
                snapshot_fn=lambda: (box["active"], box["state"]),
                train_one_fn=train_one_fn,
                get_model_fn=lambda: (box["active"], box["state"]),
                set_model_fn=set_model_fn, clock=clock)
            # a restored step that froze or finished its stage runs nothing
            done = loop.run(0 if stage_done else max(
                min(plan_rounds - r_in_stage, budget - round_idx), 0),
                start_round=round_idx)
            round_idx += len(done)
            clock = loop.clock
            restored = None  # consumed; later stages start fresh
            if flags["rollback"]:
                # unfreeze the watched stage and restore its freeze-time
                # snapshot, discarding every round trained after it
                self.rollbacks += 1
                _log.warning(
                    "freeze rollback: stage %d diverged after the freeze "
                    "(ref %.4f, guard %.2f); unfreezing stage %d and "
                    "restoring its snapshot", stage, rb_armed["ref"],
                    self.rollback_guard, rb_armed["stage"])
                params, state = rb_armed["params"], rb_armed["state"]
                stage = rb_armed["stage"]
                rb_armed = None
                recent_losses.clear()
                continue
            # --- model growth ---
            params = fz.merge_cnn_params(model, params, stage, box["active"])
            state = box["state"]
            rb_armed = None  # the watched stage survived its probation
            if (self.freeze_rollback and flags["freeze"]
                    and self.rollbacks < self.max_rollbacks
                    and stage + 1 < n_stages):
                ref = (float(np.mean(recent_losses)) if recent_losses
                       else float("inf"))
                rb_armed = {"stage": stage, "params": params, "state": state,
                            "ref": ref, "bad": 0}
            stage += 1
        return {"params": params, "state": state, "history": self.history,
                "rounds": round_idx, "virtual_time": clock}

    def _save_ckpt(self, mgr, rec, stage, stage_base, box, pace, engine,
                   plan_rounds, r_in_stage, frozen_flag):
        tree = {"params": stage_base, "active": box["active"],
                "state": box["state"], "pace": pace.state_dict(),
                "selector": selector_state_tree(self.selector),
                "last_loss": pack_float_map(self._last_loss)}
        ef = engine.ef_state()
        if ef is not None:
            tree["ef"] = ef
        # only when the cache was filled or re-tiered since the last save:
        # a checkpoint without one re-encodes from the restored frozen tree
        cache = engine.cache_state_if_changed()
        if cache is not None:
            tree["cache"] = cache
        mgr.save(rec.round_idx, tree, metadata={
            "stage": stage, "round_idx": rec.round_idx,
            "r_in_stage": int(r_in_stage), "plan_rounds": int(plan_rounds),
            "clock": float(rec.t_end), "frozen": bool(frozen_flag)})


class FedAvgServer:
    """Vanilla FL baseline: the full model every round, a random cohort of
    the clients with at least ``mem_required`` bytes. Runs on the same
    ``FederatedLoop`` as SmartFreeze, so it takes the same ``aggregation``
    / ``time_model`` / ``availability`` knobs (sync, deadline,
    async-buffered) and reports per-round virtual durations in its
    history; ``faults``, ``screen_updates`` and ``aggregator`` are
    ``SmartFreezeServer``'s, and so is ``device``."""

    def __init__(self, model: CNN, clients: List[SimClient], *,
                 optimizer_fn: Callable[[], Optimizer] = lambda: sgd(0.05),
                 clients_per_round: int = 10, local_epochs: int = 1,
                 batch_size: int = 32, mem_required: float = 0.0,
                 seed: int = 0, fused: bool = True,
                 compress_ratio: Optional[float] = None,
                 compute_dtype: Optional[str] = None,
                 aggregation: Union[str, object, None] = None,
                 time_model: Optional[FleetTimeModel] = None,
                 availability: Optional[AvailabilityTrace] = None,
                 screen_updates: bool = False, aggregator: str = "mean",
                 faults: Optional[FaultInjector] = None,
                 device="cuda"):
        _check_aggregator(aggregator)
        self.device = resolve_device(device)
        self.model = model
        self.clients = {c.client_id: c for c in clients}
        self.optimizer_fn = optimizer_fn
        self.k = clients_per_round
        self.local_epochs = local_epochs
        self.batch_size = batch_size
        self.mem_required = mem_required
        self.seed = seed
        self.fused = fused
        self.compress_ratio = compress_ratio
        self.compute_dtype = compute_dtype
        self.aggregation = aggregation
        self.time_model = time_model
        self.availability = availability
        self.screen_updates = screen_updates
        self.aggregator = aggregator
        self.faults = faults
        self.history: List[RoundResult] = []

    def run(self, params, state, *, rounds: int,
            eval_fn: Optional[Callable] = None, eval_every: int = 10,
            ckpt_manager=None, ckpt_every: int = 0,
            resume: bool = False) -> Dict:
        """``eval_fn(params, state, last_stage)`` runs every
        ``eval_every`` rounds. ``ckpt_manager`` / ``ckpt_every`` save the
        params, BN state, residual pools and the selection stream every N
        rounds; ``resume=True`` continues from the newest committed
        step."""
        model = self.model
        n_stages = len(model.cfg.stage_sizes)

        def full_loss(p, frozen_unused, st, batch):
            return model.loss(p, st, batch, train=True)

        engine = RoundEngine(loss_fn=full_loss, optimizer=self.optimizer_fn(),
                             batch_size=self.batch_size,
                             local_epochs=self.local_epochs, clip_norm=10.0,
                             fused=self.fused,
                             compress_ratio=self.compress_ratio,
                             compute_dtype=self.compute_dtype,
                             device=self.device, screen=self.screen_updates,
                             aggregator=self.aggregator)
        rng = np.random.RandomState(self.seed)
        eligible = [cid for cid, c in self.clients.items()
                    if c.memory_bytes >= self.mem_required]
        participation = len(eligible) / len(self.clients)
        clock = 0.0
        start_round = 0
        if resume and ckpt_manager is not None:
            try:
                ck = ckpt_manager.restore()
            except FileNotFoundError:
                ck = None
            if ck is not None:
                params = tree_like(params, ck["tree"]["params"])
                state = tree_like(state, ck["tree"]["state"])
                rng = unpack_rng_state(ck["tree"]["rng"])
                if "ef" in ck["tree"]:
                    engine.load_ef_state(ck["tree"]["ef"])
                clock = float(ck["metadata"]["clock"])
                start_round = int(ck["metadata"]["round_idx"]) + 1
        if not eligible or start_round >= rounds:
            return {"params": params, "state": state, "history": self.history,
                    "participation": participation, "virtual_time": clock}

        box = {"params": params, "state": state}
        elig_set = set(eligible)

        def select_fn(r, avail):
            cands = [c for c in avail if c in elig_set]
            if not cands:
                return []
            return list(rng.choice(cands, size=min(self.k, len(cands)),
                                   replace=False))

        def train_fn(cohort, r, sequential=None, faults=None):
            box["params"], box["state"], losses = engine.run_round(
                self.clients, cohort, box["params"], box["state"], r,
                sequential=sequential, faults=faults)
            return losses

        def train_one_fn(cid, p, s, r):
            p_i, s_i, losses = engine.run_round(self.clients, [cid], p, s, r,
                                                sequential=True)
            return p_i, s_i, losses[cid]

        def on_round(rec):
            prev = self.history[-1].loss if self.history else None
            rr = RoundResult(rec.round_idx, n_stages - 1,
                             _mean_loss(rec.losses, prev=prev),
                             selected=rec.selected,
                             uplink_bytes=engine.last_uplink_bytes,
                             duration=rec.duration, virtual_time=rec.t_end,
                             dropped=rec.dropped, screened=_screened(engine))
            if eval_fn is not None and rec.round_idx % eval_every == 0:
                rr.test_acc = eval_fn(box["params"], box["state"],
                                      n_stages - 1)
            self.history.append(rr)
            if ckpt_manager is not None and ckpt_every and (
                    (rec.round_idx + 1) % ckpt_every == 0):
                tree = {"params": box["params"], "state": box["state"],
                        "rng": pack_rng_state(rng)}
                ef = engine.ef_state()
                if ef is not None:
                    tree["ef"] = ef
                ckpt_manager.save(rec.round_idx, tree, metadata={
                    "round_idx": rec.round_idx, "clock": float(rec.t_end)})
            return False

        tm = (dataclasses.replace(self.time_model)
              if self.time_model is not None
              else FleetTimeModel.from_clients(self.clients))
        tm.payload_bytes = engine.per_client_uplink_bytes(box["params"])
        loop = FederatedLoop(
            select_fn=select_fn, train_fn=train_fn, clients=self.clients,
            client_ids=list(self.clients),
            aggregation=self.aggregation or "sync", time_model=tm,
            availability=self.availability, faults=self.faults,
            on_round=on_round,
            snapshot_fn=lambda: (box["params"], box["state"]),
            train_one_fn=train_one_fn,
            get_model_fn=lambda: (box["params"], box["state"]),
            set_model_fn=lambda p, s: box.update(params=p, state=s),
            clock=clock)
        loop.run(rounds - start_round, start_round=start_round)
        return {"params": box["params"], "state": box["state"],
                "history": self.history, "participation": participation,
                "virtual_time": loop.clock}
