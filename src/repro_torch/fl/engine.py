"""Federated round engine: local SGD per client, the Eq. 1 fold, and a
frozen-prefix feature cache (counterpart of ``repro/fl/engine.py``'s
``weighted_avg``, ``make_fused_round`` and ``RoundEngine`` on the default
sync path).

The client axis is a Python loop. The reference lowers a round to one XLA
program and picks between ``vmap(lax.scan(...))`` and a statically
unrolled client loop by backend, because XLA-CPU runs convolutions inside
``while`` bodies slowly; that choice is an XLA artefact. PyTorch runs
eagerly: each client's steps launch their own kernels on the stream, the
host only enqueues, and one sync per round reads the losses back. So a
loop is the direct form, and it needs no padding of short clients to the
cohort's longest plan: each client runs exactly its live steps.

With ``compress_ratio`` set, every client's trained leaves are compressed
by ``ingraph_compress_leaf`` (delta + error feedback, top-k), and each
leaf's cohort is folded by ONE ``sparse_cohort_add`` kernel launch per
cache group. Error-feedback residuals live on the device in per-leaf
[n_clients_seen, L] row pools. BN state is always a dense weighted average.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fl.client import SimClient, batch_index_plan
from repro_torch.fl.compression import ingraph_compress_leaf, topk_keep
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import (Optimizer, apply_updates,
                               clip_by_global_norm)

LossFn = Callable[[Any, Any, Any, Dict], Tuple[torch.Tensor, Any]]
#   loss_fn(params, frozen, state, batch) -> (loss, new_state)


def weighted_avg(trees: Sequence, w) -> Any:
    """Dataset-weighted average of param trees (Eq. 1): products in f32,
    then a left-fold sum, cast back to each leaf's dtype."""
    trees = list(trees)
    ref = tree_leaves(trees[0])
    wt = torch.as_tensor(np.asarray(w, np.float32), device=ref[0].device
                         if ref else "cpu")
    prods = [tree_map(lambda x, i=i: x.float() * wt[i], t)
             for i, t in enumerate(trees)]
    out = prods[0]
    for p in prods[1:]:
        out = tree_map(torch.add, out, p)
    return tree_map(lambda a, r: a.to(r.dtype), out, trees[0])


def _wsum(acc, tree, wi):
    contrib = tree_map(lambda b: wi * b.float(), tree)
    return contrib if acc is None else tree_map(torch.add, acc, contrib)


def _cast_like(acc, ref):
    return tree_map(lambda a, r: a.to(r.dtype), acc, ref)


def make_fused_round(loss_fn: LossFn, optimizer: Optimizer, *,
                     clip_norm: float = 10.0,
                     compress_ratio: Optional[float] = None):
    """Build the round function.

    ``round_fn(params, frozen, state, batches, weights)``
      params:  cohort-shared start params
      frozen:  frozen-prefix tree (``{}`` when unused)
      state:   cohort-shared BN state
      batches: one dict per client of tensors with leading dims
               [n_steps, batch, ...]; a client runs exactly n_steps local
               SGD steps (0 is allowed: its params come back unchanged)
      weights: [K] f32 tensor — Eq. 1 weights (|D_i|)
      -> (agg_params, agg_state, per_client_mean_loss [K])

    With ``compress_ratio`` set the call takes ``residuals`` (a
    params-shaped tree of [K, L] f32 error-feedback rows) and also returns
    the new residuals. ``compress_ratio=1.0`` still goes through the
    sparse fold and reproduces the dense Eq. 1 aggregate (allclose).
    """

    def local_train(params, frozen, state, batches):
        opt_state = optimizer.init(params)
        p, st = params, state
        n = next(iter(batches.values())).shape[0]
        lsum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for t in range(n):
            batch = {k: v[t] for k, v in batches.items()}
            req = tree_map(lambda x: x.detach().requires_grad_(True), p)
            loss, st2 = loss_fn(req, frozen, st, batch)
            grads = torch.autograd.grad(loss, tree_leaves(req))
            grads = tree_unflatten(req, grads)
            with torch.no_grad():
                grads, _ = clip_by_global_norm(grads, clip_norm)
                ups, opt_state = optimizer.update(grads, opt_state, p)
                p = apply_updates(tree_map(torch.Tensor.detach, req), ups)
            st = tree_map(torch.Tensor.detach, st2)
            lsum = lsum + loss.detach()
        return p, st, lsum / max(n, 1)

    def round_fn(params, frozen, state, batches, weights, residuals=None):
        if (residuals is None) != (compress_ratio is None):
            raise ValueError("residuals go with compress_ratio, and only "
                             "with it")
        w = (weights / torch.sum(weights)).float()
        agg_p = agg_st = None
        trained, losses = [], []
        for i, b in enumerate(batches):
            p_i, st_i, loss_i = local_train(params, frozen, state, b)
            if compress_ratio is None:
                agg_p = _wsum(agg_p, p_i, w[i])
            else:
                trained.append(tree_leaves(p_i))
            agg_st = _wsum(agg_st, st_i, w[i])
            losses.append(loss_i)
        losses = torch.stack(losses)
        agg_st = _cast_like(agg_st, state)
        if compress_ratio is None:
            return _cast_like(agg_p, params), agg_st, losses
        new_p, new_r = [], []
        with torch.no_grad():
            for j, (p0, r) in enumerate(zip(tree_leaves(params),
                                            tree_leaves(residuals))):
                ends = torch.stack([t[j].float().reshape(-1) for t in trained])
                agg, r_new, _, _ = ingraph_compress_leaf(
                    p0.float().reshape(-1), ends, r, w, compress_ratio)
                new_p.append(agg.reshape(p0.shape).to(p0.dtype))
                new_r.append(r_new)
        return (tree_unflatten(params, new_p), agg_st, losses,
                tree_unflatten(params, new_r))

    return round_fn


@dataclass
class RoundEngine:
    """Executes federated rounds for a cohort of ``SimClient``s.

    ``loss_fn`` is the full-recompute stage loss; ``cached_loss_fn`` (when
    given) is its twin over pre-extracted prefix features under the same
    ``batch["x"]`` key; ``feature_fn(x) -> features`` is the frozen prefix.
    All three close over the current stage, so a fresh engine is built at
    every stage boundary — which also drops the feature cache and the
    error-feedback residuals, whose shapes follow the stage's params.

    The feature cache holds each admitted client's shard, pushed once
    through the frozen prefix, as f32 tensors on ``device`` (the
    reference's ``"f32"`` tier; fp16 and int8 tiers are not ported).

    ``device`` defaults to the card and raises when CUDA is absent.
    """

    loss_fn: LossFn
    optimizer: Optimizer
    frozen: Any = None
    cached_loss_fn: Optional[LossFn] = None
    feature_fn: Optional[Callable] = None
    batch_size: int = 32
    local_epochs: int = 1
    clip_norm: float = 10.0
    compress_ratio: Optional[float] = None
    device: torch.device = "cuda"
    last_uplink_bytes: int = 0
    _features: Dict[int, torch.Tensor] = field(default_factory=dict,
                                               repr=False)
    _round_fns: Dict[bool, Callable] = field(default_factory=dict, repr=False)
    _res_pool: List[torch.Tensor] = field(default_factory=list, repr=False)
    _res_row: Dict[int, int] = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ----- frozen-prefix feature cache (f32) -----

    def features_for(self, client: SimClient) -> torch.Tensor:
        """Client's shard pushed through the frozen prefix once (eval
        mode), memoized until the engine (== the stage) is replaced."""
        feats = self._features.get(client.client_id)
        if feats is None:
            x = torch.as_tensor(client.data["x"], device=self.device)
            with torch.no_grad():
                feats = self.feature_fn(x).float().contiguous()
            self._features[client.client_id] = feats
        return feats

    def cache_nbytes(self) -> int:
        """Resident feature-cache bytes."""
        return sum(f.numel() * f.element_size()
                   for f in self._features.values())

    # ----- error-feedback residual state (on device, per client) -----

    def _residual_rows(self, cids: List[int], leaves) -> torch.Tensor:
        """Pool row per client, growing the per-leaf [cap, L] pools
        (zero rows == empty residual) as new clients appear."""
        for cid in cids:
            if cid not in self._res_row:
                self._res_row[cid] = len(self._res_row)
        need = len(self._res_row)
        if not self._res_pool:
            self._res_pool = [torch.zeros(need, l.numel(), device=self.device)
                              for l in leaves]
        elif self._res_pool[0].shape[0] < need:
            cap = max(need, 2 * self._res_pool[0].shape[0])
            self._res_pool = [
                torch.cat([p, p.new_zeros(cap - p.shape[0], p.shape[1])])
                for p in self._res_pool]
        return torch.as_tensor([self._res_row[c] for c in cids],
                               device=self.device)

    def client_residuals(self, cid: int) -> List[torch.Tensor]:
        """This client's per-leaf error-feedback residual vectors."""
        row = self._res_row[cid]
        return [p[row] for p in self._res_pool]

    def per_client_uplink_bytes(self, params) -> int:
        """One client's uplink payload for the current stage."""
        return self._uplink_bytes(params, 1)

    def _uplink_bytes(self, params, n_clients: int) -> int:
        """(index, value) payload per client, summed over the cohort; the
        dense f32 params without compression."""
        leaves = tree_leaves(params)
        if self.compress_ratio is None:
            return n_clients * sum(l.numel() * 4 for l in leaves)
        return n_clients * sum(topk_keep(l.numel(), self.compress_ratio) * 8
                               for l in leaves)

    # ----- round execution -----

    def run_round(self, clients: Dict[int, SimClient], selected: List[int],
                  params, state, round_idx: int, *,
                  use_cache: Optional[Dict[int, Optional[str]]] = None
                  ) -> Tuple[Any, Any, Dict[int, float]]:
        """One federated round over ``selected``. Returns (params, state,
        per-client mean loss). The cohort splits into a cached group and a
        recompute group (their batches differ), each runs as one fused
        round, and the group aggregates combine by total weight — the same
        Eq. 1 average as one flat cohort. ``use_cache`` maps client ids to
        ``"f32"`` (cached) or ``None`` (recompute)."""
        use_cache = use_cache or {}
        self.last_uplink_bytes = 0
        groups: Dict[bool, List[int]] = {}
        for cid in selected:
            tier = use_cache.get(cid) if self.cached_loss_fn is not None else None
            if tier not in (None, "f32"):
                raise ValueError(f"cache tier {tier!r} is not ported; only "
                                 "'f32' or None")
            groups.setdefault(tier is not None, []).append(cid)
        partials = []
        losses: Dict[int, float] = {}
        for cached, cids in groups.items():
            p_g, s_g, l_g, w_g = self._run_fused(clients, cids, params, state,
                                                 round_idx, cached=cached)
            partials.append((p_g, s_g, w_g))
            losses.update(l_g)
        if len(partials) == 1:
            return partials[0][0], partials[0][1], losses
        w = np.asarray([p[2] for p in partials], np.float64)
        w /= w.sum()
        return (weighted_avg([p[0] for p in partials], w),
                weighted_avg([p[1] for p in partials], w), losses)

    def _client_batches(self, client: SimClient, plan: List[np.ndarray],
                        cached: bool) -> Dict[str, torch.Tensor]:
        idx = (np.stack(plan) if plan
               else np.zeros((0, self.batch_size), np.int64))
        out = {}
        for key, arr in client.data.items():
            if key == "x" and cached:
                feats = self.features_for(client)
                out[key] = feats[torch.as_tensor(idx, device=self.device)]
            else:
                out[key] = torch.as_tensor(arr[idx], device=self.device)
        return out

    def _run_fused(self, clients, cids, params, state, round_idx, *, cached):
        plans = [batch_index_plan(clients[c].num_samples, self.batch_size,
                                  self.local_epochs,
                                  clients[c].round_seed(round_idx))
                 for c in cids]
        batches = [self._client_batches(clients[c], plan, cached)
                   for c, plan in zip(cids, plans)]
        weights = np.asarray([clients[c].num_samples for c in cids],
                             np.float32)
        fn = self._round_fns.get(cached)
        if fn is None:
            fn = self._round_fns[cached] = make_fused_round(
                self.cached_loss_fn if cached else self.loss_fn,
                self.optimizer, clip_norm=self.clip_norm,
                compress_ratio=self.compress_ratio)
        frozen = {} if cached else (self.frozen if self.frozen is not None else {})
        w_dev = torch.as_tensor(weights, device=self.device)
        if self.compress_ratio is not None:
            rows = self._residual_rows(cids, tree_leaves(params))
            residuals = tree_unflatten(params, [p[rows] for p in self._res_pool])
            p_g, s_g, l_g, new_r = fn(params, frozen, state, batches, w_dev,
                                      residuals)
            for pool, r in zip(self._res_pool, tree_leaves(new_r)):
                pool[rows] = r
        else:
            p_g, s_g, l_g = fn(params, frozen, state, batches, w_dev)
        self.last_uplink_bytes += self._uplink_bytes(params, len(cids))
        l_host = l_g.cpu().numpy()  # the round's one blocking sync
        return (p_g, s_g, {c: float(l_host[i]) for i, c in enumerate(cids)},
                float(weights.sum()))
