"""The paper's six baselines (§V-A) on the CNN testbed (counterpart of
``repro/fl/baselines.py``).

AllSmall     — width-scale the whole model to the minimum client memory.
ExclusiveFL  — vanilla FedAvg, only clients that fit the FULL model.
DepthFL      — depth-scaled submodels + auxiliary classifiers, per-stage agg.
HeteroFL     — per-client width scaling, overlapping-slice aggregation.
TiFL         — tier clients by round time, sample within a tier.
Oort         — utility-based selection (stat util x time penalty).

Each returns the history format of ``fl/server.py``'s servers, so the
baselines and SmartFreeze plot together (paper Figs. 7-8 / Table I).

Local training runs through ``fl/engine.py`` (DepthFL and HeteroFL run
one engine round per depth or scale group) and round orchestration
through ``fl/sim.py``'s ``FederatedLoop``, so every baseline takes
``aggregation`` (sync or deadline; the submodel baselines have no
single-model async hooks), ``time_model``, ``availability``, ``fused``,
``compress_ratio`` and ``compute_dtype``. With ``compress_ratio`` each
group's cohort is folded by the ``sparse_cohort_add`` kernel on the card.
Every runner also takes ``faults`` (a ``fl/faults.FaultInjector``, handed
to the loop), ``screen_updates`` and ``aggregator`` (handed to every
engine), so each method runs under the same fault schedule as the
servers; DepthFL and HeteroFL give each group's engine its clients'
corruption faults.

Every runner takes ``device`` (the card by default; it raises when CUDA is
absent).

Initial values come from ``torch.Generator``s seeded with ``seed`` (the
model) and ``seed + 1`` (DepthFL's auxiliary heads); ``jax.random``
streams cannot be reproduced, so parity tests carry the reference's
initial values across.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.memory_model import cnn_stage_memory_bytes
from repro_torch.core.output_module import cnn_fc_only_apply, cnn_fc_only_init
from repro_torch.core.selector.bandit import UtilBandit
from repro_torch.fl.client import SimClient
from repro_torch.fl.engine import RoundEngine, weighted_avg
from repro_torch.fl.server import FedAvgServer, RoundResult, _mean_loss
from repro_torch.fl.sim import FederatedLoop, FleetTimeModel
from repro_torch.models.cnn import CNN, CNNConfig, softmax_xent
from repro_torch.models.module import ParamFactory, tree_map
from repro_torch.optim import sgd

__all__ = ["full_model_memory", "scaled_config", "depthfl_depths",
           "heterofl_scales", "run_allsmall", "run_exclusivefl",
           "run_depthfl", "run_heterofl", "run_tifl", "run_oort"]

def full_model_memory(model: CNN, batch_size: int) -> float:
    n = len(model.cfg.stage_sizes)
    return sum(cnn_stage_memory_bytes(model, s, batch_size) for s in range(n))


def scaled_config(cfg: CNNConfig, scale: float) -> CNNConfig:
    chans = tuple(max(int(c * scale), 4) for c in cfg.stage_channels)
    return dataclasses.replace(cfg, stage_channels=chans,
                               name=f"{cfg.name}_x{scale:g}")


def _run_loop(clients_by_id, select_fn, train_fn, on_round, rounds, *,
              aggregation="sync", time_model=None, availability=None,
              faults=None):
    """One-liner over ``FederatedLoop`` shared by the baseline runners."""
    loop = FederatedLoop(select_fn=select_fn, train_fn=train_fn,
                         clients=clients_by_id,
                         client_ids=list(clients_by_id),
                         aggregation=aggregation, time_model=time_model,
                         availability=availability, on_round=on_round,
                         faults=faults)
    loop.run(rounds)
    return loop


def _history_hook(history, n_stages, eval_fn, model, box):
    """``on_round`` of the runners' loops: a ``RoundResult`` a tick, with
    ``eval_fn(model, params, state)`` every 10 rounds."""

    def on_round(rec):
        prev = history[-1].loss if history else None
        rr = RoundResult(rec.round_idx, n_stages - 1,
                         _mean_loss(rec.losses, prev=prev),
                         selected=rec.selected, duration=rec.duration,
                         virtual_time=rec.t_end, dropped=rec.dropped)
        if eval_fn is not None and rec.round_idx % 10 == 0:
            rr.test_acc = eval_fn(model, box["params"], box["state"])
        history.append(rr)
        return False

    return on_round


def _group_faults(faults, cids):
    """The corruption faults of one engine group's clients (None when
    none of them faults)."""
    return ({c: k for c, k in faults.items() if c in cids}
            if faults else None) or None


def _random_select(rng: np.random.RandomState, k: int):
    def select_fn(r, avail):
        return list(rng.choice(avail, size=min(k, len(avail)),
                               replace=False))
    return select_fn


# ---------------------------------------------------------------------------
# AllSmall
# ---------------------------------------------------------------------------


def run_allsmall(cfg: CNNConfig, clients: List[SimClient], *, rounds: int,
                 batch_size: int = 32, eval_fn=None, seed: int = 0,
                 device="cuda", **kw) -> Dict:
    """Scale channels until the model fits the SMALLEST client memory."""
    min_mem = min(c.memory_bytes for c in clients)
    scale = 1.0
    while scale > 0.05:
        model = CNN(scaled_config(cfg, scale), device=device)
        if full_model_memory(model, batch_size) <= min_mem:
            break
        scale *= 0.5
    model = CNN(scaled_config(cfg, scale), device=device)
    params, state = model.init(torch.Generator().manual_seed(seed))
    srv = FedAvgServer(model, clients, batch_size=batch_size, seed=seed,
                       device=device, **kw)
    out = srv.run(params, state, rounds=rounds,
                  eval_fn=(lambda p, s, st: eval_fn(model, p, s))
                  if eval_fn else None)
    out["scale"] = scale
    out["model"] = model
    return out


# ---------------------------------------------------------------------------
# ExclusiveFL
# ---------------------------------------------------------------------------


def run_exclusivefl(cfg: CNNConfig, clients: List[SimClient], *, rounds: int,
                    batch_size: int = 32, eval_fn=None, seed: int = 0,
                    device="cuda", **kw) -> Dict:
    model = CNN(cfg, device=device)
    req = full_model_memory(model, batch_size)
    eligible = [c for c in clients if c.memory_bytes >= req]
    out: Dict = {"participation": len(eligible) / len(clients), "history": []}
    if not eligible:
        out["inoperative"] = True  # paper: ResNet18/VGG16 scenarios
        return out
    params, state = model.init(torch.Generator().manual_seed(seed))
    srv = FedAvgServer(model, clients, batch_size=batch_size,
                       mem_required=req, seed=seed, device=device, **kw)
    res = srv.run(params, state, rounds=rounds,
                  eval_fn=(lambda p, s, st: eval_fn(model, p, s))
                  if eval_fn else None)
    res["participation"] = out["participation"]
    res["model"] = model
    return res


# ---------------------------------------------------------------------------
# DepthFL
# ---------------------------------------------------------------------------


def depthfl_depths(model: CNN, clients: List[SimClient],
                   batch_size: int) -> Dict[int, int]:
    """Each client's depth: the last stage s whose stages [0..s] fit its
    memory (0 when none does)."""
    n_stages = len(model.cfg.stage_sizes)
    need = np.cumsum([cnn_stage_memory_bytes(model, t, batch_size)
                      for t in range(n_stages)])
    depths = {}
    for c in clients:
        d = 0
        for s in range(n_stages):
            if c.memory_bytes >= need[s]:
                d = s
        depths[c.client_id] = d
    return depths


def run_depthfl(cfg: CNNConfig, clients: List[SimClient], *, rounds: int,
                batch_size: int = 32, clients_per_round: int = 10,
                eval_fn=None, seed: int = 0, local_epochs: int = 1,
                fused: bool = True, compress_ratio=None, compute_dtype=None,
                aggregation="sync", time_model=None, availability=None,
                screen_updates: bool = False, aggregator: str = "mean",
                faults=None, device="cuda") -> Dict:
    """Depth-scaled submodels: client c trains stages [0..d_c) + aux head.

    A client of depth d carries every stage in its tree but its loss reads
    only stages 0..d, so the deeper stages get zero gradients and come
    back from its round unchanged."""
    model = CNN(cfg, device=device)
    n_stages = len(cfg.stage_sizes)
    params, state = model.init(torch.Generator().manual_seed(seed))
    clients_by_id = {c.client_id: c for c in clients}
    # aux classifier per non-final depth
    fac = ParamFactory(torch.Generator().manual_seed(seed + 1), model.device)
    aux = {d: cnn_fc_only_init(fac, cfg, d) for d in range(n_stages - 1)}
    depths = depthfl_depths(model, clients, batch_size)
    participation = np.mean([depths[c.client_id] == n_stages - 1
                             for c in clients])

    def make_engine(depth: int) -> RoundEngine:
        def loss_fn(p, frozen_unused, st, batch):
            h = batch["x"]
            if cfg.kind == "resnet":
                h, st = model.stem(p, st, h, train=True)
            h, st = model.run_stages(p, st, h, 0, depth + 1, train=True)
            logits = model.head(p, h) if depth == n_stages - 1 \
                else cnn_fc_only_apply(p["aux"], h)
            return softmax_xent(logits, batch["y"]), st

        return RoundEngine(loss_fn=loss_fn, optimizer=sgd(0.05),
                           batch_size=batch_size, local_epochs=local_epochs,
                           fused=fused, compress_ratio=compress_ratio,
                           compute_dtype=compute_dtype, device=model.device,
                           screen=screen_updates, aggregator=aggregator)

    engines = {d: make_engine(d) for d in range(n_stages)}
    rng = np.random.RandomState(seed)
    history: List[RoundResult] = []
    box = {"params": params, "state": state}

    def train_fn(sel, r, sequential=None, faults=None):
        params, state = box["params"], box["state"]
        # one engine round per depth group (shapes are homogeneous within)
        by_depth: Dict[int, List[int]] = {}
        for cid in sel:
            by_depth.setdefault(depths[cid], []).append(cid)
        group_out: Dict[int, Dict] = {}
        losses: Dict[int, float] = {}
        for d, cids in by_depth.items():
            sub = {k: params[k] for k in params if k != "fc"}
            if d == n_stages - 1:
                sub["fc"] = params["fc"]
            else:
                sub["aux"] = aux[d]
            p_g, s_g, l_g = engines[d].run_round(
                clients_by_id, cids, sub, state, r, sequential=sequential,
                faults=_group_faults(faults, cids))
            W_g = float(sum(clients_by_id[c].num_samples for c in cids))
            group_out[d] = {"params": p_g, "state": s_g, "weight": W_g}
            losses.update(l_g)
        # per-stage aggregation over depth groups that trained the stage
        new_params = dict(params)
        new_params["stages"] = dict(new_params["stages"])
        for s in range(n_stages):
            having = [g for d, g in group_out.items() if d >= s]
            if not having:
                continue
            ws = np.asarray([g["weight"] for g in having])
            ws = ws / ws.sum()
            new_params["stages"][f"stage{s}"] = weighted_avg(
                [g["params"]["stages"][f"stage{s}"] for g in having], ws)
        ws_all = np.asarray([g["weight"] for g in group_out.values()])
        ws_all = ws_all / ws_all.sum()
        if cfg.kind == "resnet":
            new_params["stem"] = weighted_avg(
                [g["params"]["stem"] for g in group_out.values()], ws_all)
        if n_stages - 1 in group_out:
            new_params["fc"] = group_out[n_stages - 1]["params"]["fc"]
        for d in range(n_stages - 1):
            if d in group_out:
                aux[d] = group_out[d]["params"]["aux"]
        box["params"] = new_params
        box["state"] = weighted_avg([g["state"] for g in group_out.values()],
                                    ws_all)
        return losses

    _run_loop(clients_by_id, _random_select(rng, clients_per_round),
              train_fn, _history_hook(history, n_stages, eval_fn, model, box),
              rounds, aggregation=aggregation, time_model=time_model,
              availability=availability, faults=faults)
    return {"params": box["params"], "state": box["state"], "history": history,
            "participation": float(participation), "model": model}


# ---------------------------------------------------------------------------
# HeteroFL
# ---------------------------------------------------------------------------


_HFL_SCALES = (1.0, 0.5, 0.25, 0.125)


class _ShapeFactory(ParamFactory):
    """A factory of meta tensors: an init through it gives every leaf's
    shape and draws no number."""

    def __init__(self):
        super().__init__(None, "meta")

    def param(self, shape, *, dtype=None, **kw):
        full = ((self.stack,) if self.stack else ()) + tuple(shape)
        return torch.empty(full, dtype=dtype or self.dtype, device="meta")


def _slice_like(full, small):
    """Upper-left slice of `full` with `small`'s shape."""
    return full[tuple(slice(0, s) for s in small.shape)]


def heterofl_scales(cfg: CNNConfig, clients: List[SimClient],
                    batch_size: int) -> Dict[int, float]:
    """Each client's width: the largest of ``_HFL_SCALES`` whose model
    fits its memory (the smallest when none does)."""
    need = {s: full_model_memory(CNN(scaled_config(cfg, s), device="cpu"),
                                 batch_size) for s in _HFL_SCALES}
    scale_of = {}
    for c in clients:
        sc = _HFL_SCALES[-1]
        for s in _HFL_SCALES:
            if need[s] <= c.memory_bytes:
                sc = s
                break
        scale_of[c.client_id] = sc
    return scale_of


def run_heterofl(cfg: CNNConfig, clients: List[SimClient], *, rounds: int,
                 batch_size: int = 32, clients_per_round: int = 10,
                 eval_fn=None, seed: int = 0, local_epochs: int = 1,
                 fused: bool = True, compress_ratio=None, compute_dtype=None,
                 aggregation="sync", time_model=None, availability=None,
                 screen_updates: bool = False, aggregator: str = "mean",
                 faults=None, device="cuda") -> Dict:
    """Width-scaled submodels: a client of scale s trains the upper-left
    slice of every leaf that the scale-s model has. The groups' trees sum
    into f64 accumulators on the params' device, weighted by the group's
    samples; a position no group trained keeps its value."""
    model_full = CNN(cfg, device=device)
    dev = model_full.device
    params_full, state_full = model_full.init(
        torch.Generator().manual_seed(seed))
    clients_by_id = {c.client_id: c for c in clients}
    scale_of = heterofl_scales(cfg, clients, batch_size)
    models = {s: CNN(scaled_config(cfg, s), device=dev) for s in _HFL_SCALES}
    sub_shapes = {s: m.init_from(_ShapeFactory()) for s, m in models.items()}

    def make_engine(scale) -> RoundEngine:
        model_s = models[scale]

        def loss_fn(p, frozen_unused, st, batch):
            return model_s.loss(p, st, batch, train=True)

        return RoundEngine(loss_fn=loss_fn, optimizer=sgd(0.05),
                           batch_size=batch_size, local_epochs=local_epochs,
                           fused=fused, compress_ratio=compress_ratio,
                           compute_dtype=compute_dtype, device=dev,
                           screen=screen_updates, aggregator=aggregator)

    engines = {s: make_engine(s) for s in _HFL_SCALES}
    rng = np.random.RandomState(seed)
    history: List[RoundResult] = []
    n_stages = len(cfg.stage_sizes)
    box = {"params": params_full, "state": state_full}

    def zeros64(x):
        return torch.zeros(x.shape, dtype=torch.float64, device=x.device)

    def train_fn(sel, r, sequential=None, faults=None):
        params_full, state_full = box["params"], box["state"]
        by_scale: Dict[float, List[int]] = {}
        for cid in sel:
            by_scale.setdefault(scale_of[cid], []).append(cid)
        # one engine round per scale group, then overlapping-slice agg
        acc, cnt = tree_map(zeros64, params_full), tree_map(zeros64,
                                                            params_full)
        acc_s, cnt_s = tree_map(zeros64, state_full), tree_map(zeros64,
                                                               state_full)
        losses: Dict[int, float] = {}
        for sc, cids in by_scale.items():
            sub_shape, sub_state_shape = sub_shapes[sc]
            sub = tree_map(_slice_like, params_full, sub_shape)
            sub_st = tree_map(_slice_like, state_full, sub_state_shape)
            p_g, s_g, l_g = engines[sc].run_round(
                clients_by_id, cids, sub, sub_st, r, sequential=sequential,
                faults=_group_faults(faults, cids))
            W_g = float(sum(clients_by_id[c].num_samples for c in cids))
            losses.update(l_g)

            def add(a, c_, small):
                sl = tuple(slice(0, s) for s in small.shape)
                a[sl] += small.double() * W_g
                c_[sl] += W_g

            tree_map(add, acc, cnt, p_g)
            tree_map(add, acc_s, cnt_s, s_g)

        def finalize(a, c_, full):
            return torch.where(c_ > 0, a / c_, full.double()).to(full.dtype)

        box["params"] = tree_map(finalize, acc, cnt, params_full)
        box["state"] = tree_map(finalize, acc_s, cnt_s, state_full)
        return losses

    _run_loop(clients_by_id, _random_select(rng, clients_per_round),
              train_fn,
              _history_hook(history, n_stages, eval_fn, model_full, box),
              rounds, aggregation=aggregation, time_model=time_model,
              availability=availability, faults=faults)
    return {"params": box["params"], "state": box["state"], "history": history,
            "participation": 1.0, "model": model_full}


# ---------------------------------------------------------------------------
# TiFL / Oort (selection-strategy baselines; full model required)
# ---------------------------------------------------------------------------


def _full_model_engine(model, optimizer, batch_size, local_epochs, fused,
                       compress_ratio, compute_dtype, screen_updates,
                       aggregator) -> RoundEngine:
    def full_loss(p, frozen_unused, st, batch):
        return model.loss(p, st, batch, train=True)

    return RoundEngine(loss_fn=full_loss, optimizer=optimizer,
                       batch_size=batch_size, local_epochs=local_epochs,
                       fused=fused, compress_ratio=compress_ratio,
                       compute_dtype=compute_dtype, device=model.device,
                       screen=screen_updates, aggregator=aggregator)


def _payload_time_model(time_model, clients_by_id, engine, params):
    """A copy of the caller's time model (or the fleet's default) charged
    with the full model's uplink payload."""
    tm = (dataclasses.replace(time_model) if time_model is not None
          else FleetTimeModel.from_clients(clients_by_id))
    tm.payload_bytes = engine.per_client_uplink_bytes(params)
    return tm


def run_tifl(cfg: CNNConfig, clients: List[SimClient], *, rounds: int,
             batch_size: int = 32, clients_per_round: int = 10,
             eval_fn=None, seed: int = 0, device="cuda", **kw) -> Dict:
    """Tiers by ``|D_i| / c_i`` (the 0.33 and 0.66 quantiles); each round
    samples one tier, round-robin over the non-empty tiers."""
    optimizer_fn = kw.pop("optimizer_fn", lambda: sgd(0.05))
    local_epochs = kw.pop("local_epochs", 1)
    fused = kw.pop("fused", True)
    compress_ratio = kw.pop("compress_ratio", None)
    compute_dtype = kw.pop("compute_dtype", None)
    aggregation = kw.pop("aggregation", "sync")
    time_model = kw.pop("time_model", None)
    availability = kw.pop("availability", None)
    screen_updates = kw.pop("screen_updates", False)
    aggregator = kw.pop("aggregator", "mean")
    faults = kw.pop("faults", None)
    if kw:
        raise TypeError(f"run_tifl: unknown kwargs {sorted(kw)}")
    model = CNN(cfg, device=device)
    req = full_model_memory(model, batch_size)
    eligible = [c for c in clients if c.memory_bytes >= req]
    if not eligible:
        return {"inoperative": True, "participation": 0.0, "history": []}
    times = {c.client_id: c.num_samples / c.capability for c in eligible}
    qs = np.quantile(list(times.values()), [0.33, 0.66])
    tiers = {0: [], 1: [], 2: []}
    for c in eligible:
        t = times[c.client_id]
        tier = 0 if t <= qs[0] else (1 if t <= qs[1] else 2)
        tiers[tier].append(c.client_id)
    params, state = model.init(torch.Generator().manual_seed(seed))
    clients_by_id = {c.client_id: c for c in eligible}
    engine = _full_model_engine(model, optimizer_fn(), batch_size,
                                local_epochs, fused, compress_ratio,
                                compute_dtype, screen_updates, aggregator)
    n_stages = len(cfg.stage_sizes)
    rng = np.random.RandomState(seed)
    history: List[RoundResult] = []
    box = {"params": params, "state": state}

    def select_fn(r, avail):
        avail_set = set(avail)
        live = [t for t in tiers.values() if t]
        tier = [c for c in live[r % len(live)] if c in avail_set]
        if not tier:
            return []
        return list(rng.choice(tier, size=min(clients_per_round, len(tier)),
                               replace=False))

    def train_fn(sel, r, sequential=None, faults=None):
        box["params"], box["state"], losses = engine.run_round(
            clients_by_id, sel, box["params"], box["state"], r,
            sequential=sequential, faults=faults)
        return losses

    _run_loop(clients_by_id, select_fn, train_fn,
              _history_hook(history, n_stages, eval_fn, model, box), rounds,
              aggregation=aggregation,
              time_model=_payload_time_model(time_model, clients_by_id,
                                             engine, params),
              availability=availability, faults=faults)
    return {"params": box["params"], "state": box["state"], "history": history,
            "participation": len(eligible) / len(clients), "model": model}


def run_oort(cfg: CNNConfig, clients: List[SimClient], *, rounds: int,
             batch_size: int = 32, clients_per_round: int = 10,
             eval_fn=None, seed: int = 0, local_epochs: int = 1,
             fused: bool = True, compress_ratio=None, compute_dtype=None,
             aggregation="sync", time_model=None, availability=None,
             screen_updates: bool = False, aggregator: str = "mean",
             faults=None, device="cuda") -> Dict:
    """Selection by an epsilon-greedy bandit over Oort's statistical
    utility ``|D_i| sqrt(loss^2) - 0.1 |D_i| / c_i``."""
    model = CNN(cfg, device=device)
    req = full_model_memory(model, batch_size)
    eligible = [c for c in clients if c.memory_bytes >= req]
    if not eligible:
        return {"inoperative": True, "participation": 0.0, "history": []}
    clients_by_id = {c.client_id: c for c in eligible}
    params, state = model.init(torch.Generator().manual_seed(seed))
    bandit = UtilBandit(epsilon=0.3, seed=seed)
    engine = _full_model_engine(model, sgd(0.05), batch_size, local_epochs,
                                fused, compress_ratio, compute_dtype,
                                screen_updates, aggregator)
    history: List[RoundResult] = []
    n_stages = len(cfg.stage_sizes)
    box = {"params": params, "state": state}

    def select_fn(r, avail):
        return list(bandit.pick(avail, min(clients_per_round, len(avail))))

    def train_fn(sel, r, sequential=None, faults=None):
        box["params"], box["state"], losses = engine.run_round(
            clients_by_id, sel, box["params"], box["state"], r,
            sequential=sequential, faults=faults)
        for cid, loss_i in losses.items():
            if not np.isfinite(loss_i):
                continue  # a non-finite round must not poison utility
            c = clients_by_id[cid]
            # Oort stat util: |D_i| sqrt(mean loss^2) - time penalty
            t_i = c.num_samples / c.capability
            bandit.update(cid,
                          c.num_samples * np.sqrt(loss_i ** 2) - 0.1 * t_i)
        bandit.next_round()
        return losses

    _run_loop(clients_by_id, select_fn, train_fn,
              _history_hook(history, n_stages, eval_fn, model, box), rounds,
              aggregation=aggregation,
              time_model=_payload_time_model(time_model, clients_by_id,
                                             engine, params),
              availability=availability, faults=faults)
    return {"params": box["params"], "state": box["state"], "history": history,
            "participation": len(eligible) / len(clients), "model": model}
