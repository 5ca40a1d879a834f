"""SmartFreeze server for the CNN testbed, sync path (counterpart of
``repro/fl/server.py:SmartFreezeServer``).

``run`` executes the paper's pipeline end to end:
  (1) split the model into T stages and bootstrap the Eq. 8 client
      similarity from one-shot output-layer gradients;
  (2) fit RL-CD communities;
  (3) per stage: participant selection (Eq. 11-14) -> local training ->
      Eq. 1 aggregation (compressed uplinks folded by the CUDA kernel) ->
      the pace controller observes the block perturbation and freezes the
      stage when it has converged;
  (4) grow the model until every stage is trained.

Not ported in this slice, and rejected with ``TypeError`` rather than
ignored: ``mesh``, ``faults``, ``screen_updates``, ``aggregator``,
``freeze_rollback`` (and its knobs), ``compute_dtype``, ``cache_tiers``
other than ``("f32",)``, the deadline and async policies
(``deadline_factor``, ``aggregation`` other than sync), ``availability``,
``fused`` and ``use_pallas``, and ``run``'s ``ckpt_manager`` and
``resume``. The compressed fold always goes through
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
from repro_torch.core.memory_model import (CACHE_TIER_DTYPES,
                                           cache_tier_ladder,
                                           cnn_stage_memory_bytes)
from repro_torch.core.pace import PaceController
from repro_torch.core.selector import ParticipantSelector
from repro_torch.core.selector.similarity import similarity_matrix
from repro_torch.core.time_model import cnn_cached_compute_scale
from repro_torch.fl.client import SimClient
from repro_torch.fl.engine import RoundEngine
from repro_torch.fl.sim import FederatedLoop, FleetTimeModel, resolve_policy
from repro_torch.models.cnn import CNN
from repro_torch.models.module import tree_leaves
from repro_torch.optim import Optimizer, sgd

__all__ = ["SmartFreezeServer", "RoundResult"]


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
    cache_bytes: Optional[int] = None    # resident feature cache


_log = logging.getLogger(__name__)


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
                 seed: int = 0, cache_features: bool = True,
                 cache_tiers: Union[tuple, list] = ("f32",),
                 cache_time_scale: bool = False,
                 compress_ratio: Optional[float] = None,
                 aggregation: Union[str, object, None] = None,
                 time_model: Optional[FleetTimeModel] = None,
                 device="cuda"):
        if tuple(cache_tiers) != ("f32",):
            raise TypeError(f"cache_tiers={cache_tiers!r} is not ported; "
                            "only ('f32',)")
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
        self.seed = seed
        self.cache_features = cache_features
        self.cache_time_scale = cache_time_scale
        self.compress_ratio = compress_ratio
        self.policy = resolve_policy(aggregation or "sync")
        self.time_model = time_model
        self.history: List[RoundResult] = []
        self._last_loss: Dict[int, float] = {}
        self.image_size = int(next(iter(self.clients.values())).data["x"].shape[1])

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
            clip_norm=10.0, compress_ratio=self.compress_ratio,
            device=self.device)

    def _cache_plan(self, stage: int) -> Dict[int, Optional[str]]:
        """Eq. 12 admission of the f32 feature cache per client: granted
        when the stage requirement plus the shard's prefix activations
        fits the client's memory; ``None`` recomputes the prefix."""
        if not self.cache_features or stage == 0:
            return {}
        plan = {}
        for cid, c in self.clients.items():
            plan[cid] = cache_tier_ladder(
                c.memory_bytes,
                lambda t, _n=c.num_samples: cnn_stage_memory_bytes(
                    self.model, stage, self.batch_size, self.image_size,
                    cache_samples=_n, cache_dtype=CACHE_TIER_DTYPES[t]),
                tiers=("f32",))
        return plan

    # ----- main loop (one FederatedLoop per stage) -----

    def run(self, params, state, *, eval_fn: Optional[Callable] = None,
            eval_every: int = 10, total_rounds: Optional[int] = None,
            schedule: Optional[List[int]] = None) -> Dict:
        """schedule: optional fixed rounds per stage (pace-controller
        ablation). ``eval_fn(params, state, stage)`` runs every
        ``eval_every`` rounds and at pace freezes."""
        model = self.model
        n_stages = len(model.cfg.stage_sizes)
        budget = total_rounds or self.rounds_per_stage * n_stages
        clock = 0.0
        round_idx = 0
        self.selector.fit_communities(self.bootstrap_similarity(params, state))

        for stage in range(n_stages):
            if schedule is not None:
                plan_rounds = schedule[stage]
            else:
                # pace-adaptive budget: early freezes hand their unused
                # rounds to later stages (>= 1 round per remaining stage)
                plan_rounds = max(budget - round_idx - (n_stages - stage - 1), 1)
            pace = PaceController(**self.pace_kwargs)
            frozen, active = fz.init_cnn_stage_active(
                model, params, stage,
                torch.Generator().manual_seed(self.seed + stage),
                op_kind=self.op_kind)
            engine = self._stage_engine(stage, frozen, state)
            cache_ok = self._cache_plan(stage)
            mem_req = cnn_stage_memory_bytes(model, stage, self.batch_size,
                                             self.image_size)
            stage_base = params
            box = {"active": active, "state": state}
            time_fn = lambda ci: ci.num_samples / ci.capability

            def select_fn(r, avail):
                infos = {cid: dataclasses.replace(
                    self.clients[cid].info(),
                    loss_sum=(self._last_loss.get(cid, 1e3)
                              * self.clients[cid].num_samples))
                    for cid in avail}
                # Eq. 11-14: I_{t,i} = |D_i| * latest local loss
                return self.selector.select(infos, self.k,
                                            mem_required=mem_req,
                                            stage_time_fn=time_fn)

            def train_fn(cohort, r):
                box["active"], box["state"], losses = engine.run_round(
                    self.clients, cohort, box["active"], box["state"], r,
                    use_cache=cache_ok)
                self._last_loss.update(
                    {c: v for c, v in losses.items() if np.isfinite(v)})
                return losses

            def on_round(rec):
                p = pace.observe(box["active"].get("stages", box["active"]))
                prev = self.history[-1].loss if self.history else None
                loss = _mean_loss(rec.losses, prev=prev)
                do_freeze = pace.should_freeze() and schedule is None
                rr = RoundResult(rec.round_idx, stage, loss,
                                 selected=rec.selected, perturbation=p,
                                 frozen=do_freeze,
                                 uplink_bytes=engine.last_uplink_bytes,
                                 duration=rec.duration,
                                 virtual_time=rec.t_end,
                                 cache_bytes=engine.cache_nbytes())
                if eval_fn is not None and (rec.round_idx % eval_every == 0
                                            or do_freeze):
                    merged = fz.merge_cnn_params(model, stage_base, stage,
                                                 box["active"])
                    rr.test_acc = eval_fn(merged, box["state"], stage)
                self.history.append(rr)
                return do_freeze

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
            loop = FederatedLoop(select_fn=select_fn, train_fn=train_fn,
                                 clients=self.clients,
                                 client_ids=list(self.clients),
                                 aggregation=self.policy, time_model=tm,
                                 on_round=on_round, clock=clock)
            done = loop.run(max(min(plan_rounds, budget - round_idx), 0),
                            start_round=round_idx)
            round_idx += len(done)
            clock = loop.clock
            # --- model growth ---
            params = fz.merge_cnn_params(model, params, stage, box["active"])
            state = box["state"]
        return {"params": params, "state": state, "history": self.history,
                "rounds": round_idx, "virtual_time": clock}
