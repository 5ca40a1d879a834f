"""Federated round engine: local SGD per client, the Eq. 1 fold, and a
tiered frozen-prefix feature cache (counterpart of ``repro/fl/engine.py``'s
``weighted_avg``, ``make_fused_round`` and ``RoundEngine``, with its
sequential escape hatch).

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

The feature cache stores each admitted client's prefix features at its
tier (``fl/quant.py``: f32, fp16, or int8 with f32 scales) on the device,
and a round runs each tier's clients as one group. With
``compute_dtype="bfloat16"`` local training runs on a bf16 copy of the
params; the master params, the optimizer state and the Eq. 1 fold stay
f32.

``make_lm_cached_fed_round_step`` is the LM's cached round: the pods of
``core/freezing.py:make_fed_round_step`` trained on frozen-prefix features
computed once per stage (``stage_prefix_features``) and stored at a cache
tier, so only the active suffix runs and is differentiated.

The sequential escape hatch (``sequential=True``, or ``fused=False``) runs
the same local step for one client at a time and compresses each client's
update on its own: the deadline policy's straggler rounds and every async
completion take it, so the fold runs there with K = 1.

Defenses (``screen``, a robust ``aggregator``, injected corruption): the
round keeps every client's trained tree, corrupts the faulty ones in delta
space (``fl/faults.py``), and screens rows with a non-finite loss or delta
or a delta norm past ``screen_norm_mult`` x the cohort's median. While
every live row passes and nothing was corrupted, the aggregate is the
undefended round's fold over the same trees, bit for bit; otherwise the
kept rows are recombined by Eq. 1 on f64 weights (``_recombine_kept``), or
by a per-coordinate ``trimmed_mean`` / ``coord_median``. A round whose
every row is screened out is a no-op. None of this composes with
``compress_ratio``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.fl.client import SimClient, batch_index_plan
from repro_torch.fl.compression import ingraph_compress_leaf, topk_keep
from repro_torch.fl.faults import (CORRUPT_KINDS, FAULT_CODE,
                                   apply_fault_to_update, corrupt_codes)
from repro_torch.fl.quant import (CACHE_TIERS, EncodedFeatures,
                                  cast_floating, encode_features,
                                  feature_batch_arrays, make_input_cast_loss,
                                  make_tiered_loss, normalize_tier)
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


# ---------------------------------------------------------------------------
# Update screening and robust aggregation
# ---------------------------------------------------------------------------


AGGREGATORS = ("mean", "trimmed_mean", "coord_median")
_CODE_KIND = {code: kind for kind, code in FAULT_CODE.items()}


def _apply_fault_codes(params, trained: List, losses: torch.Tensor,
                       codes, amplify: float):
    """Each client's trained tree corrupted in delta space per ``codes[i]``
    (0 = clean, ``fl/faults.FAULT_CODE``): a clean row keeps its trained
    tree untouched; NaN and Inf rows also report a NaN loss."""
    out, losses = list(trained), losses.clone()
    for i, c in enumerate(np.asarray(codes)):
        kind = _CODE_KIND.get(int(c))
        if kind is None:
            continue
        out[i] = apply_fault_to_update(kind, params, out[i], amplify=amplify)
        if kind in ("nan", "inf"):
            losses[i] = float("nan")
    return out, losses


def _delta_norm_one(params, p_i) -> torch.Tensor:
    """f32 global L2 norm of one client's param delta (a NaN or Inf
    anywhere surfaces as a non-finite norm)."""
    sq = None
    for p0, pk in zip(tree_leaves(params), tree_leaves(p_i)):
        d = pk.float() - p0.float()
        s = torch.sum(d * d)
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _delta_norms(params, trained: Sequence) -> torch.Tensor:
    """[K] f32 delta norms of the cohort's trained trees."""
    return torch.stack([_delta_norm_one(params, p_i) for p_i in trained])


def _lower_median(sorted_vals: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Lower median of the first ``n_valid`` entries of an ascending-sorted
    vector whose invalid tail is +inf (inf when nothing is valid)."""
    return sorted_vals[max(int(n_valid) - 1, 0) // 2]


def _keep_mask(norms, losses, weights, mult: float) -> torch.Tensor:
    """Screening mask: drop rows with a non-finite loss or delta, and rows
    whose delta norm exceeds ``mult`` x the cohort's lower median norm
    (plus 1e-6). Inert rows (weight 0) are left out of the median and
    never kept."""
    valid = torch.isfinite(norms) & torch.isfinite(losses) & (weights > 0)
    n_v = int(valid.sum())
    med = _lower_median(torch.sort(torch.where(
        valid, norms, torch.full_like(norms, float("inf")))).values, n_v)
    outlier = torch.isfinite(med) & (norms > mult * med + 1e-6)
    return valid & ~outlier


def _verdict(norms, losses, weights, screen: bool, mult: float,
             aggregator: str) -> torch.Tensor:
    """Which rows a defended round keeps: ``_keep_mask`` when screening; a
    robust aggregator alone still drops non-finite rows (they would
    poison the order statistics); fault injection alone lets corruption
    into the mean."""
    if screen:
        return _keep_mask(norms, losses, weights, mult)
    if aggregator != "mean":
        return torch.isfinite(norms) & torch.isfinite(losses) & (weights > 0)
    return weights > 0


def _robust_leaf(x: torch.Tensor, keep: torch.Tensor, n_valid: int,
                 aggregator: str, trim_beta: float) -> torch.Tensor:
    """Per-coordinate robust combine of a stacked [K, ...] leaf over the
    kept rows: ``coord_median`` (the mean of the two middle order
    statistics) or ``trimmed_mean`` (drop floor(beta * n) from each end,
    the unweighted mean of the band). Masked rows sort to +inf and the
    order statistics index only the valid prefix."""
    n = int(n_valid)
    xf = x.float()
    kcol = keep.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    s = torch.sort(torch.where(kcol, xf, torch.full_like(xf, float("inf"))),
                   dim=0).values
    if aggregator == "coord_median":
        lo = max(n - 1, 0) // 2
        hi = max(n - 1, 0) - lo
        out = (s[lo] + s[hi]) * 0.5
    else:  # trimmed_mean
        t = int(np.floor(np.float32(trim_beta) * np.float32(n)))
        t = min(t, max(n - 1, 0) // 2)
        out = s[t:n - t].sum(dim=0) / float(max(n - 2 * t, 1))
    return out.to(x.dtype)


def _robust_combine(trees: Sequence, keep: torch.Tensor, aggregator: str,
                    trim_beta: float):
    """``_robust_leaf`` over every leaf of the stacked ``trees``."""
    n = int(keep.sum())
    leaves = [torch.stack(ls) for ls in zip(*(tree_leaves(t)
                                              for t in trees))]
    if leaves:
        keep = keep.to(leaves[0].device)
    return tree_unflatten(trees[0], [
        _robust_leaf(x, keep, n, aggregator, trim_beta) for x in leaves])


def _recombine_kept(params, state, out_p: Sequence, out_st: Sequence,
                    k_host: np.ndarray, weights):
    """Eq. 1 over the kept rows alone, on f64 weights renormalized over
    them: a screened row is dropped, never weighted by 0 (0 x NaN is
    NaN). With every row screened out the round is a no-op."""
    if not k_host.any():
        return params, state
    idx = np.nonzero(k_host)[0]
    w = np.asarray(weights, np.float64)[idx]
    w /= w.sum()
    return (weighted_avg([out_p[i] for i in idx], w),
            weighted_avg([out_st[i] for i in idx], w))


def make_local_train(loss_fn: LossFn, optimizer: Optimizer, *,
                     clip_norm: float = 10.0,
                     compute_dtype: Optional[str] = None):
    """One client's local SGD, the step both round paths run.

    ``local_train(params, frozen, state, batches)`` runs the n_steps of
    ``batches`` (tensors with leading dims [n_steps, batch, ...]; 0 steps
    is allowed) from ``params`` with a fresh optimizer state and returns
    (params, state, [per-step loss tensors]). ``compute_dtype``
    (``"bfloat16"``) trains in mixed precision, as the reference does:
    each step takes the gradients with respect to a bf16 copy of the
    params, with the client's frozen tree cast once and the batch's
    floating entries (but not its ``*_scale`` entries) cast, and casts
    them back to f32. The carried params are f32 master weights, the
    optimizer state stays f32, BN state returns in its dtype and the loss
    in f32. ``None`` is the f32 loop.
    """
    cdt = getattr(torch, compute_dtype) if compute_dtype is not None else None
    loss_fn = make_input_cast_loss(loss_fn, compute_dtype)

    def local_train(params, frozen, state, batches):
        opt_state = optimizer.init(params)
        if cdt is not None:
            frozen = cast_floating(frozen, cdt)
        p, st = params, state
        n = next(iter(batches.values())).shape[0]
        losses = []
        for t in range(n):
            batch = {k: v[t] for k, v in batches.items()}
            req = tree_map(lambda x: x.detach().requires_grad_(True),
                           p if cdt is None else cast_floating(p, cdt))
            loss, st2 = loss_fn(req, frozen, st, batch)
            # a leaf the loss never reads (a DepthFL client's deeper
            # stages) gets a zero gradient, as under jax.grad
            grads = torch.autograd.grad(loss, tree_leaves(req),
                                        allow_unused=True,
                                        materialize_grads=True)
            grads = tree_unflatten(req, grads)
            with torch.no_grad():
                if cdt is not None:
                    grads = tree_map(lambda g, m: g.to(m.dtype), grads, p)
                    st2 = tree_map(lambda a, m: a.to(m.dtype), st2, st)
                    loss = loss.float()
                grads, _ = clip_by_global_norm(grads, clip_norm)
                ups, opt_state = optimizer.update(grads, opt_state, p)
                p = apply_updates(tree_map(torch.Tensor.detach, p), ups)
            st = tree_map(torch.Tensor.detach, st2)
            losses.append(loss.detach())
        return p, st, losses

    return local_train


def make_fused_round(loss_fn: LossFn, optimizer: Optimizer, *,
                     clip_norm: float = 10.0,
                     compress_ratio: Optional[float] = None,
                     compute_dtype: Optional[str] = None,
                     screen: bool = False, screen_norm_mult: float = 8.0,
                     aggregator: str = "mean", trim_beta: float = 0.2,
                     inject_faults: bool = False,
                     fault_amplify: float = 50.0):
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

    ``compute_dtype`` is ``make_local_train``'s; the Eq. 1 fold stays f32.

    ``screen``, a robust ``aggregator`` or ``inject_faults`` build the
    defended round, ``round_fn(params, frozen, state, batches, weights,
    fault_codes=None) -> (agg_params, agg_state, losses, keep)``:
    ``fault_codes`` is a [K] int array of ``fl/faults.FAULT_CODE``s (None
    for a clean round) and ``keep`` the [K] bool screen verdict. Rows with
    a non-finite loss or delta, or (with ``screen``) a delta norm past
    ``screen_norm_mult`` x the cohort's lower median, are screened out.
    With every live row kept and no codes, the aggregate is the undefended
    round's, bit for bit; otherwise ``_recombine_kept`` folds the kept
    rows. ``aggregator`` ``"trimmed_mean"`` (``trim_beta`` from each end)
    or ``"coord_median"`` combines the kept rows per coordinate, params
    and BN state alike; with no row kept the round returns its inputs.
    Defenses raise ``ValueError`` with ``compress_ratio``.
    """
    if aggregator not in AGGREGATORS:
        raise ValueError(f"unknown aggregator {aggregator!r}; "
                         f"choose from {AGGREGATORS}")
    defended = screen or inject_faults or aggregator != "mean"
    if compress_ratio is not None and defended:
        raise ValueError(
            "screening / robust aggregation / fault injection do not "
            "compose with the compressed uplink (error-feedback residuals "
            "would carry the corrupted signal forward); use "
            "compress_ratio=None")
    train = make_local_train(loss_fn, optimizer, clip_norm=clip_norm,
                             compute_dtype=compute_dtype)

    def local_train(params, frozen, state, batches):
        p, st, step_losses = train(params, frozen, state, batches)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for loss in step_losses:
            lsum = lsum + loss
        return p, st, lsum / max(len(step_losses), 1)

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

    def defended_fn(params, frozen, state, batches, weights,
                    fault_codes=None):
        outs = [local_train(params, frozen, state, b) for b in batches]
        out_p, out_st = [o[0] for o in outs], [o[1] for o in outs]
        losses = torch.stack([o[2] for o in outs])
        if fault_codes is not None:
            out_p, losses = _apply_fault_codes(params, out_p, losses,
                                               fault_codes, fault_amplify)
        with torch.no_grad():
            keep = _verdict(_delta_norms(params, out_p), losses, weights,
                            screen, screen_norm_mult, aggregator)
            if aggregator != "mean":
                if not bool(keep.any()):  # never average NaN
                    return params, state, losses, keep
                return (_robust_combine(out_p, keep, aggregator, trim_beta),
                        _robust_combine(out_st, keep, aggregator,
                                        trim_beta), losses, keep)
            k_host = keep.cpu().numpy()
            w_host = weights.cpu().numpy()
            if fault_codes is None and not np.any(~k_host & (w_host > 0)):
                # every live row passed: the undefended round's fold over
                # the same trees in the same order, bit for bit
                w = (weights / torch.sum(weights)).float()
                agg_p = agg_st = None
                for i in range(len(out_p)):
                    agg_p = _wsum(agg_p, out_p[i], w[i])
                    agg_st = _wsum(agg_st, out_st[i], w[i])
                return (_cast_like(agg_p, params), _cast_like(agg_st, state),
                        losses, keep)
            agg_p, agg_st = _recombine_kept(params, state, out_p, out_st,
                                            k_host, w_host)
        return agg_p, agg_st, losses, keep

    return defended_fn if defended else round_fn


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
    through the frozen prefix and encoded at its tier on write
    (``fl/quant.py``), as tensors on ``device``. ``compute_dtype`` is
    ``make_fused_round``'s.

    ``fused=False`` sends every round to the sequential escape hatch
    (``_run_sequential``), which a round also takes with
    ``sequential=True``: each client trains alone and its update is
    compressed on its own, one fold of one client per leaf.

    ``screen`` turns on the update screen (``make_fused_round``; the
    verdicts land in ``last_screened``, True = screened out),
    ``aggregator`` picks ``"trimmed_mean"`` or ``"coord_median"``, and
    ``run_round(..., faults={cid: kind})`` corrupts the updates of the
    ``fl/faults.CORRUPT_KINDS`` clients by ``fault_amplify`` or in kind,
    on the fused and the sequential path alike. With screening on and no
    faults a round is bitwise the undefended one.

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
    fused: bool = True
    compress_ratio: Optional[float] = None
    compute_dtype: Optional[str] = None
    device: torch.device = "cuda"
    screen: bool = False
    screen_norm_mult: float = 8.0
    aggregator: str = "mean"
    trim_beta: float = 0.2
    fault_amplify: float = 50.0
    last_uplink_bytes: int = 0
    last_screened: Dict[int, bool] = field(default_factory=dict, repr=False)
    _features: Dict[int, EncodedFeatures] = field(default_factory=dict,
                                                  repr=False)
    _round_fns: Dict[Tuple, Callable] = field(default_factory=dict,
                                              repr=False)
    _seq_fns: Dict[Optional[str], Callable] = field(default_factory=dict,
                                                    repr=False)
    _res_pool: List[torch.Tensor] = field(default_factory=list, repr=False)
    _res_row: Dict[int, int] = field(default_factory=dict, repr=False)
    _cache_version: int = field(default=0, repr=False)
    _cache_saved_version: int = field(default=-1, repr=False)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    # ----- frozen-prefix feature cache (tiered) -----

    def features_for(self, client: SimClient,
                     tier: str = "f32") -> EncodedFeatures:
        """Client's shard pushed through the frozen prefix once (eval
        mode) and encoded at ``tier`` on write; memoized until the engine
        (== the stage) is replaced. A tier change extracts and encodes
        anew."""
        enc = self._features.get(client.client_id)
        if enc is None or enc.tier != tier:
            x = torch.as_tensor(client.data["x"], device=self.device)
            with torch.no_grad():
                enc = encode_features(self.feature_fn(x), tier)
            self._features[client.client_id] = enc
            self._cache_version += 1
        return enc

    def cache_nbytes(self) -> int:
        """Resident feature-cache bytes at the stored dtypes: int8 values
        and their f32 scales, not the f32 equivalent."""
        return sum(f.nbytes for f in self._features.values())

    def cache_tiers(self) -> Dict[int, str]:
        """The tier each cached client is stored at."""
        return {cid: enc.tier for cid, enc in self._features.items()}

    def cache_state(self) -> Optional[Dict[str, Any]]:
        """Per-client tiers and encoded features (int8 scales included) as
        checkpointable leaves, so a resumed run consumes the bytes the
        crashed run trained on. The values are the live cache tensors
        (``CheckpointManager.save`` copies them). None when nothing is
        cached."""
        if not self._features:
            return None
        cids = sorted(self._features)
        out = {"ids": np.asarray(cids, np.int64),
               "tiers": np.asarray([CACHE_TIERS.index(self._features[c].tier)
                                    for c in cids], np.int64)}
        for i, cid in enumerate(cids):
            enc = self._features[cid]
            out[f"val{i}"] = enc.values
            if enc.scale is not None:
                out[f"scale{i}"] = enc.scale
        return out

    def cache_state_if_changed(self) -> Optional[Dict[str, Any]]:
        """``cache_state`` only when the cache changed since the last call:
        within a stage it stops changing once every participant is
        encoded, and a checkpoint without a cache resumes by encoding the
        features anew from the restored frozen tree."""
        if (not self._features
                or self._cache_version == self._cache_saved_version):
            return None
        self._cache_saved_version = self._cache_version
        return self.cache_state()

    def load_cache_state(self, tree: Dict[str, Any]) -> None:
        """Restore ``cache_state`` output onto the engine's device at the
        stored dtypes."""
        self._features = {}
        tiers = np.asarray(tree["tiers"])
        for i, cid in enumerate(np.asarray(tree["ids"])):
            scale = tree.get(f"scale{i}")
            self._features[int(cid)] = EncodedFeatures(
                CACHE_TIERS[int(tiers[i])],
                torch.as_tensor(tree[f"val{i}"]).to(self.device),
                None if scale is None
                else torch.as_tensor(scale).to(self.device))
        self._cache_version += 1

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

    def ef_state(self) -> Optional[Dict[str, Any]]:
        """Error-feedback residual pools (the live [cap, L] f32 tensors,
        which ``CheckpointManager.save`` copies) and the client -> row map
        as checkpointable leaves; None when nothing is carried."""
        if not self._res_pool:
            return None
        cids = sorted(self._res_row)
        return {"rows_ids": np.asarray(cids, np.int64),
                "rows_idx": np.asarray([self._res_row[c] for c in cids],
                                       np.int64),
                **{f"pool{i}": p for i, p in enumerate(self._res_pool)}}

    def load_ef_state(self, tree: Dict[str, Any]) -> None:
        """Restore ``ef_state`` output: a resumed compressed run carries
        each client's untransmitted residual forward, as f32 pools on the
        engine's device."""
        self._res_row = {int(c): int(i) for c, i in
                         zip(np.asarray(tree["rows_ids"]),
                             np.asarray(tree["rows_idx"]))}
        pools, i = [], 0
        while f"pool{i}" in tree:
            pools.append(torch.as_tensor(tree[f"pool{i}"]).to(
                device=self.device, dtype=torch.float32))
            i += 1
        self._res_pool = pools

    def per_client_uplink_bytes(self, params) -> int:
        """One client's uplink payload for the current stage."""
        return self._uplink_bytes(params, 1)

    def residual_norms(self) -> Dict[int, float]:
        """Per-client ||error-feedback residual||_2 over every leaf's pool,
        reduced on the device for all clients at once (one pass a leaf
        pool, one read-back), not client by client — feeds
        ``ClientPopulation.ef_residual_norm`` for selection policies that
        prefer clients with pent-up un-transmitted signal."""
        if not self._res_pool:
            return {}
        sq = sum((p * p).sum(1) for p in self._res_pool)
        norms = torch.sqrt(sq).cpu().numpy()
        return {cid: float(norms[row]) for cid, row in self._res_row.items()}

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
                  use_cache: Optional[Dict[int, Optional[str]]] = None,
                  sequential: Optional[bool] = None,
                  faults: Optional[Dict[int, str]] = None
                  ) -> Tuple[Any, Any, Dict[int, float]]:
        """One federated round over ``selected``. Returns (params, state,
        per-client mean loss). The cohort splits into one group per cache
        tier plus a recompute group (their batches differ), in the order
        their first clients appear; each runs as one fused round, and the
        group aggregates combine by total weight — the same Eq. 1 average
        as one flat cohort. ``use_cache`` maps client ids to a tier
        (``"f32"``, ``"fp16"``, ``"int8"``; ``True`` is ``"f32"``) or
        ``None`` (recompute). ``sequential`` picks the path of every group:
        ``None`` is the engine's default (``not fused``), ``True`` the
        sequential escape hatch, ``False`` the fused round. ``faults`` maps
        cohort ids to ``fl/faults.CORRUPT_KINDS``, whose updates are
        corrupted before screening; other kinds are ignored (the
        aggregation policies drop crashed and hung clients upstream)."""
        use_cache = use_cache or {}
        seq = (not self.fused) if sequential is None else sequential
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"unknown aggregator {self.aggregator!r}; "
                             f"choose from {AGGREGATORS}")
        faults = {int(c): k for c, k in (faults or {}).items()
                  if k in CORRUPT_KINDS} or None
        if ((self.screen or self.aggregator != "mean" or faults)
                and self.compress_ratio is not None):
            raise ValueError("screening / robust aggregation / fault "
                             "injection do not compose with compress_ratio")
        self.last_uplink_bytes = 0
        self.last_screened = {}
        groups: Dict[Optional[str], List[int]] = {}
        for cid in selected:
            tier = (normalize_tier(use_cache.get(cid))
                    if self.cached_loss_fn is not None else None)
            groups.setdefault(tier, []).append(cid)
        partials = []
        losses: Dict[int, float] = {}
        for tier, cids in groups.items():
            runner = self._run_sequential if seq else self._run_fused
            p_g, s_g, l_g, w_g = runner(clients, cids, params, state,
                                        round_idx, tier=tier, faults=faults)
            partials.append((p_g, s_g, w_g))
            losses.update(l_g)
        if len(partials) == 1:
            return partials[0][0], partials[0][1], losses
        w = np.asarray([p[2] for p in partials], np.float64)
        w /= w.sum()
        return (weighted_avg([p[0] for p in partials], w),
                weighted_avg([p[1] for p in partials], w), losses)

    def _client_batches(self, client: SimClient, plan: List[np.ndarray],
                        tier: Optional[str]) -> Dict[str, torch.Tensor]:
        """The client's minibatches [n_steps, batch, ...]: host data moved
        to the device, and for a cached client its encoded features (and
        int8 scales) gathered on the device by the same index plan."""
        idx = (np.stack(plan) if plan
               else np.zeros((0, self.batch_size), np.int64))
        feats = ({} if tier is None else
                 feature_batch_arrays(self.features_for(client, tier)))
        out = {key: torch.as_tensor(arr[idx], device=self.device)
               for key, arr in client.data.items() if key not in feats}
        if feats:
            idx_dev = torch.as_tensor(idx, device=self.device)
            out.update({key: t[idx_dev] for key, t in feats.items()})
        return out

    def _group_loss_fn(self, tier: Optional[str]) -> LossFn:
        """The group's loss: a cached group consumes its encoded features,
        decoded inside the loss (``fl/quant.py:make_tiered_loss``)."""
        if tier is None:
            return self.loss_fn
        return make_tiered_loss(self.cached_loss_fn, tier, self.compute_dtype)

    def _run_fused(self, clients, cids, params, state, round_idx, *, tier,
                   faults=None):
        codes = corrupt_codes(faults, cids)
        defended = (self.screen or self.aggregator != "mean"
                    or codes is not None)
        plans = [batch_index_plan(clients[c].num_samples, self.batch_size,
                                  self.local_epochs,
                                  clients[c].round_seed(round_idx))
                 for c in cids]
        batches = [self._client_batches(clients[c], plan, tier)
                   for c, plan in zip(cids, plans)]
        weights = np.asarray([clients[c].num_samples for c in cids],
                             np.float32)
        # an undefended round keeps its own function; a defended one is
        # keyed by its defenses and whether it corrupts
        key = ((tier, self.screen, self.aggregator, codes is not None)
               if defended else (tier,))
        fn = self._round_fns.get(key)
        if fn is None:
            fn = self._round_fns[key] = make_fused_round(
                self._group_loss_fn(tier), self.optimizer,
                clip_norm=self.clip_norm, compress_ratio=self.compress_ratio,
                compute_dtype=self.compute_dtype,
                screen=self.screen and defended,
                screen_norm_mult=self.screen_norm_mult,
                aggregator=self.aggregator if defended else "mean",
                trim_beta=self.trim_beta, inject_faults=codes is not None,
                fault_amplify=self.fault_amplify)
        frozen = ({} if tier is not None else
                  (self.frozen if self.frozen is not None else {}))
        w_dev = torch.as_tensor(weights, device=self.device)
        if self.compress_ratio is not None:
            rows = self._residual_rows(cids, tree_leaves(params))
            residuals = tree_unflatten(params, [p[rows] for p in self._res_pool])
            p_g, s_g, l_g, new_r = fn(params, frozen, state, batches, w_dev,
                                      residuals)
            for pool, r in zip(self._res_pool, tree_leaves(new_r)):
                pool[rows] = r
        elif defended:
            p_g, s_g, l_g, keep = fn(params, frozen, state, batches, w_dev,
                                     codes)
            if self.screen:
                self.last_screened.update(
                    {c: not bool(k) for c, k in zip(cids, keep.tolist())})
        else:
            p_g, s_g, l_g = fn(params, frozen, state, batches, w_dev)
        self.last_uplink_bytes += self._uplink_bytes(params, len(cids))
        l_host = l_g.cpu().numpy()  # the round's one blocking sync
        return (p_g, s_g, {c: float(l_host[i]) for i, c in enumerate(cids)},
                float(weights.sum()))

    # ----- sequential escape hatch (deadline / straggler / async path) -----

    def _seq_train(self, tier: Optional[str]):
        fn = self._seq_fns.get(tier)
        if fn is None:
            fn = self._seq_fns[tier] = make_local_train(
                self._group_loss_fn(tier), self.optimizer,
                clip_norm=self.clip_norm, compute_dtype=self.compute_dtype)
        return fn

    def _seq_compress(self, params, p_i, cid: int):
        """One client's update through ``ingraph_compress_leaf`` alone (K =
        1, weight 1, its own residual row): the fused round's compression
        math, so both paths send the same entries."""
        leaves = tree_leaves(params)
        self._residual_rows([cid], leaves)
        row = self._res_row[cid]
        one = torch.ones(1, dtype=torch.float32, device=self.device)
        new_p = []
        with torch.no_grad():
            for p0, pi, pool in zip(leaves, tree_leaves(p_i), self._res_pool):
                sent, r_new, _, _ = ingraph_compress_leaf(
                    p0.float().reshape(-1), pi.float().reshape(1, -1),
                    pool[row][None, :], one, self.compress_ratio)
                new_p.append(sent.reshape(p0.shape).to(p0.dtype))
                pool[row] = r_new[0]
        return tree_unflatten(params, new_p)

    def _run_sequential(self, clients, cids, params, state, round_idx, *,
                        tier, faults=None):
        """Each client trains alone from the round-start params with a
        fresh optimizer state on its own batch plan; its losses come back
        in one read and average in f64, as the reference's per-step reads
        do. The group combines by the Eq. 1 weighted average. Defended, a
        faulty client's update is corrupted on the host
        (``apply_fault_to_update``), each update's delta norm is taken
        alone, and the kept updates combine by Eq. 1 over themselves or by
        the robust aggregator; with every update kept and none corrupted
        the combine is the undefended one."""
        train = self._seq_train(tier)
        frozen = ({} if tier is not None else
                  (self.frozen if self.frozen is not None else {}))
        faults = faults or {}
        defended = (self.screen or self.aggregator != "mean"
                    or any(cid in faults for cid in cids))
        updates, weights, losses = [], [], {}
        for cid in cids:
            c = clients[cid]
            plan = batch_index_plan(c.num_samples, self.batch_size,
                                    self.local_epochs,
                                    c.round_seed(round_idx))
            p_i, s_i, step_losses = train(params, frozen, state,
                                          self._client_batches(c, plan, tier))
            if self.compress_ratio is not None:
                p_i = self._seq_compress(params, p_i, cid)
            l_host = (torch.stack(step_losses).cpu().numpy()
                      if step_losses else np.zeros(1))
            losses[cid] = float(np.mean(l_host, dtype=np.float64))
            kind = faults.get(cid)
            if kind is not None:
                p_i = apply_fault_to_update(kind, params, p_i,
                                            amplify=self.fault_amplify)
                if kind in ("nan", "inf"):
                    losses[cid] = float("nan")
            updates.append((p_i, s_i))
            weights.append(c.num_samples)
        self.last_uplink_bytes += self._uplink_bytes(params, len(cids))
        w_arr = np.asarray(weights, np.float64)
        if defended:
            # the fused round's verdict on the host, in f64 as the
            # reference's sequential screen computes it
            with torch.no_grad():
                norms = torch.tensor([float(_delta_norm_one(params, u[0]))
                                      for u in updates], dtype=torch.float64)
            keep = _verdict(norms, torch.tensor([losses[c] for c in cids],
                                                dtype=torch.float64),
                            torch.as_tensor(w_arr), self.screen,
                            self.screen_norm_mult, self.aggregator).numpy()
            if self.screen:
                self.last_screened.update(
                    {cid: not bool(k) for cid, k in zip(cids, keep)})
            if not keep.any():
                # every update screened out: the group is a no-op
                return params, state, losses, float(w_arr.sum())
            kept = [u for u, k in zip(updates, keep) if k]
            if self.aggregator != "mean":
                every = torch.ones(len(kept), dtype=torch.bool,
                                   device=self.device)
                with torch.no_grad():
                    return (_robust_combine([u[0] for u in kept], every,
                                            self.aggregator, self.trim_beta),
                            _robust_combine([u[1] for u in kept], every,
                                            self.aggregator, self.trim_beta),
                            losses, float(w_arr.sum()))
            if not keep.all():
                w = w_arr[keep] / w_arr[keep].sum()
                return (weighted_avg([u[0] for u in kept], w),
                        weighted_avg([u[1] for u in kept], w), losses,
                        float(w_arr.sum()))
            # all kept under the mean: the undefended combine below
        w = w_arr / w_arr.sum()
        return (weighted_avg([u[0] for u in updates], w),
                weighted_avg([u[1] for u in updates], w), losses,
                float(np.sum(weights)))


# ---------------------------------------------------------------------------
# LM: the cached-prefix federated round
# ---------------------------------------------------------------------------


def make_lm_cached_fed_round_step(model, plan, local_opt, *, num_pods: int,
                                  local_steps: int, remat: bool = True,
                                  clip_norm: float = 1.0,
                                  feature_tier: str = "f32",
                                  compute_dtype: Optional[str] = None):
    """Cached sibling of ``core/freezing.py:make_fed_round_step``:
    ``round_step(active, batch, weights)``, whose batch carries ``h0`` and
    ``aux0`` (the frozen prefix's output and aux loss, from
    ``freezing.stage_prefix_features`` once per stage) beside the labels,
    with leading dims [num_pods, local_steps]. Only the active suffix runs
    and is differentiated; the pods share detached views of ``active``
    (no copy of the tree a pod).

    ``feature_tier`` is the cache's stored precision (``fl/quant.py``):
    with "fp16" ``h0`` arrives float16, with "int8" it arrives int8 beside
    its f32 ``h0_scale`` (``quantize_int8`` of the prefix output), and the
    step decodes it (in f32, then to the compute dtype) inside the loss.
    ``compute_dtype`` overrides the dtype the decoded features and the
    active params are evaluated in; the gradients come back in the params'
    dtypes.

    A prefix that is not static (stage 0's training embedding, or a tied
    shared-attention layer in the prefix) would train on stale features,
    so it raises ``ValueError``."""
    from repro_torch.core.freezing import (cached_stage_loss_fn, fed_round,
                                           prefix_is_static)

    if not prefix_is_static(plan):
        raise ValueError(
            f"stage {plan.stage}: frozen prefix is not a fixed feature "
            "extractor (training embedding or tied shared-attention in the "
            "prefix) — use freezing.make_fed_round_step instead")
    feature_tier = normalize_tier(feature_tier) or "f32"
    base_loss = cached_stage_loss_fn(model, plan, remat=remat)
    h_dt = getattr(torch, compute_dtype or model.cfg.compute_dtype)

    def loss_fn(act, batch):
        if feature_tier != "f32":
            batch = dict(batch)
            if feature_tier == "int8":
                batch["h0"] = (batch["h0"].float()
                               * batch.pop("h0_scale").float()).to(h_dt)
            else:
                batch["h0"] = batch["h0"].to(h_dt)
        if compute_dtype is None:
            return base_loss(act, batch)
        return base_loss(cast_floating(act, compute_dtype), batch).float()

    def round_step(active, batch: dict, weights: torch.Tensor):
        return fed_round(loss_fn, active, (), batch, weights, local_opt,
                         num_pods=num_pods, local_steps=local_steps,
                         clip_norm=clip_norm)

    return round_step
