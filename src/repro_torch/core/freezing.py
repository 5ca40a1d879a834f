"""Progressive training with layer freezing for the LM (paper §IV-A;
counterpart of the dense part of ``repro/core/freezing.py``).

Stage t trains only block t (layers [b_t, b_{t+1})) plus the output
module. Stacked layer leaves are sliced at block boundaries into a frozen
tree and an active tree (views: no copy), and the stage forward stitches
them back together in execution order.

The reference's ``stop_gradient`` memory boundary becomes a prefix run
under ``torch.no_grad()`` (embedding and frozen layers), whose output
enters the active suffix detached: eager PyTorch would otherwise keep the
graph of every frozen layer. As in the reference, the boundary also cuts
the embedding off from the loss, so at stage 0 the embedding and a
modality frontend, though in the active tree, get no gradient: torch
gives them ``None`` where JAX gives zeros. Where a zero gradient moves
nothing (SGD, momentum: the optimizer's ``zero_grad_noop``), a round
skips their update and leaves them unchanged bit for bit, as the
reference does; under AdamW, whose weight decay moves a leaf whatever its
gradient, they take zeros, which also add nothing to the global-norm
clip.

Zamba2's weight-tied shared-attention sets are in the active tree at
every stage (the tying spans blocks). A shared layer in the frozen prefix
runs under ``no_grad`` with the active weights, so only the occurrences in
the active block give them a gradient, as the reference's boundary does.

``make_fed_round_step`` is one federated round with pods as cross-silo
clients: each pod trains its own copy of the active tree for K local SGD
steps, and the Eq. 1 fold averages the pods leaf by leaf in f32 and casts
back to the param dtype. The reference's vmap over pods is a loop here
(``fed_round``, which the cached round of ``fl/engine.py`` shares).

``cached_stage_loss_fn`` is the stage loss over cached prefix features
(``fl/engine.py:make_lm_cached_fed_round_step``), and ``make_train_step``
a centralized stage step over a ``TrainState``. ``split_stage_axes`` goes
with the dry-run tools (ROADMAP A16).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.utils.checkpoint as ckpt

from repro_torch.core import output_module as op_mod
from repro_torch.models.layers import norm
from repro_torch.models.module import (ParamFactory, Params, slice_stack,
                                       tree_leaves, tree_map, tree_unflatten)
from repro_torch.models.transformer import (LM, chunked_ce_loss, layer_apply,
                                            layer_at)
from repro_torch.optim import (Optimizer, apply_updates,
                               clip_by_global_norm)


class StagePlan(NamedTuple):
    stage: int
    lo: int
    hi: int
    train_embed: bool
    final: bool  # last stage: real final_norm + head instead of output module
    # execution order: (region, kind, seg_idx, a, b), a/b relative to the
    # segment start; region in {"frozen", "active"}
    runs: tuple


def make_stage_plan(cfg, stage: Optional[int]) -> StagePlan:
    """stage=None means full-model (vanilla) training."""
    T = cfg.num_freeze_blocks
    if stage is None:
        stage, lo, hi = T - 1, 0, cfg.num_layers
        final, train_embed = True, True
    else:
        bounds = cfg.block_boundaries()
        lo, hi = bounds[stage], bounds[stage + 1]
        final = stage == T - 1
        train_embed = stage == 0
    runs = []
    pos = 0
    for si, (kind, n) in enumerate(cfg.segments()):
        s_lo, s_hi = pos, pos + n
        pos += n
        for region, r_lo, r_hi in (("frozen", 0, lo), ("active", lo, hi)):
            a, b = max(r_lo, s_lo), min(r_hi, s_hi)
            if a < b:
                runs.append((region, kind, si, a - s_lo, b - s_lo))
    return StagePlan(stage, lo, hi, train_embed, final, tuple(runs))


def split_stage_params(model: LM, params: Params, plan: StagePlan
                       ) -> Tuple[Params, Params]:
    """(frozen, active) partial trees, each with a 'runs' dict keyed by run
    index. Layer slices are views of ``params``; layers past plan.hi are
    not in either tree (the model has not grown them yet)."""
    frozen: Params = {"runs": {}}
    active: Params = {"runs": {}}
    (active if plan.train_embed else frozen)["embed"] = params["embed"]
    if "frontend" in params:
        (active if plan.train_embed else frozen)["frontend"] = \
            params["frontend"]
    for ri, (region, kind, si, a, b) in enumerate(plan.runs):
        if kind == "shared_attn":
            continue  # the tied sets, below
        tgt = active if region == "active" else frozen
        tgt["runs"][str(ri)] = slice_stack(params["segments"][str(si)], a, b)
    if "shared_attn" in params:
        active["shared_attn"] = params["shared_attn"]
    if plan.final:
        active["final_norm"] = params["final_norm"]
        if "head" in params:
            active["head"] = params["head"]
    return frozen, active


def merge_stage_params(model: LM, params: Params, plan: StagePlan,
                       active: Params) -> Params:
    """Write the trained active slices back into the full param tree.

    Unlike the functional reference, the stacked layer leaves of ``params``
    are written IN PLACE (a Llama-3-8B stack is 14 GB; the port does not
    copy it once per stage). The returned tree is a new dict that shares
    those leaves."""
    new = tree_map(lambda x: x, params)
    if plan.train_embed:
        new["embed"] = active["embed"]
        if "frontend" in active:
            new["frontend"] = active["frontend"]
    with torch.no_grad():
        for ri, (region, kind, si, a, b) in enumerate(plan.runs):
            if region != "active" or kind == "shared_attn":
                continue
            tree_map(lambda full, part: full[a:b].copy_(part),
                     new["segments"][str(si)], active["runs"][str(ri)])
    if "shared_attn" in active:
        new["shared_attn"] = active["shared_attn"]
    if plan.final:
        new["final_norm"] = active["final_norm"]
        if "head" in active:
            new["head"] = active["head"]
    return new


def _run(model: LM, h, run_params, kind: str, cfg, *, remat: bool):
    """The layers of one run, in order; ``remat`` checkpoints each layer."""
    causal = not cfg.is_encoder_only
    aux = torch.zeros((), device=h.device)
    n = tree_leaves(run_params)[0].shape[0]
    for i in range(n):
        lp = layer_at(run_params, i)
        if remat:
            h, a = ckpt.checkpoint(layer_apply, lp, h, cfg, kind,
                                   causal=causal, use_reentrant=False)
        else:
            h, a = layer_apply(lp, h, cfg, kind, causal=causal)
        aux = aux + a
    return h, aux


def prefix_is_static(plan: StagePlan) -> bool:
    """True when the frozen prefix is a fixed feature extractor for the
    whole stage (its outputs could be cached): false at stage 0, where the
    embedding is in the active tree, and when the prefix holds a
    weight-tied shared-attention layer, whose weights are active at every
    stage and keep moving."""
    if plan.train_embed:
        return False
    return not any(kind == "shared_attn"
                   for region, kind, si, a, b in plan.runs
                   if region == "frozen")


def _shared_idx(model: LM, seg_idx: int) -> int:
    """The tied set of the shared-attention segment ``seg_idx``."""
    return model._shared_attn_index(model._seg_table()[seg_idx][2])


def _run_region(model: LM, h, tree, active, ri, kind, si, *,
                remat: bool):
    """One run of the plan: the layers of ``tree["runs"][ri]``, or a shared
    attention layer with the active tree's tied set."""
    cfg = model.cfg
    if kind == "shared_attn":
        return layer_apply(active["shared_attn"][str(_shared_idx(model, si))],
                           h, cfg, kind, causal=not cfg.is_encoder_only)
    return _run(model, h, tree["runs"][str(ri)], kind, cfg, remat=remat)


def stage_prefix_features(model: LM, frozen: Params, active: Params,
                          batch: dict, plan: StagePlan):
    """Embed + frozen-prefix forward, under ``torch.no_grad()``. Returns
    (hidden, aux_loss_so_far)."""
    cfg = model.cfg
    src = active if plan.train_embed else frozen
    with torch.no_grad():
        h = model.embed(src, batch)
        aux_total = torch.zeros((), device=h.device)
        for ri, (region, kind, si, a, b) in enumerate(plan.runs):
            if region == "active":
                break
            h, aux = _run_region(model, h, frozen, active, ri, kind, si,
                                 remat=False)
            aux_total = aux_total + aux
    return h, aux_total


def stage_forward_from_features(model: LM, active: Params, h, aux_total,
                                plan: StagePlan, *, remat: bool = True):
    """Active-suffix forward from prefix features: the memory boundary
    (``h`` enters detached), the active runs, then the final norm and head
    or the output module. Returns (hidden, head_w, aux_loss)."""
    cfg = model.cfg
    h = h.detach()
    for ri, (region, kind, si, a, b) in enumerate(plan.runs):
        if region != "active":
            continue
        h, aux = _run_region(model, h, active, active, ri, kind, si,
                             remat=remat)
        aux_total = aux_total + aux
    if plan.final:
        h = norm(active["final_norm"], h, cfg.norm, cfg.norm_eps)
        head_w = (active["embed"].T if cfg.tie_embeddings
                  else active["head"]["w"])
    else:
        h = op_mod.lm_op_hidden(active["op"], h, cfg)
        head_w = active["op"]["head"]["w"]
    return h, head_w, aux_total


def stage_forward(model: LM, frozen: Params, active: Params, batch: dict,
                  plan: StagePlan, *, remat: bool = True):
    """(hidden, head_w, aux_loss); the head matmul is folded into the
    chunked CE loss so [B, S, V] logits are never held."""
    h, aux = stage_prefix_features(model, frozen, active, batch, plan)
    return stage_forward_from_features(model, active, h, aux, plan,
                                       remat=remat)


def stage_logits(model: LM, frozen: Params, active: Params, batch: dict,
                 plan: StagePlan, *, remat: bool = True):
    """Full [B, S, V] logits and the aux loss (tests and small models)."""
    h, head_w, aux = stage_forward(model, frozen, active, batch, plan,
                                   remat=remat)
    return h @ head_w.to(h.dtype), aux


def stage_loss_fn(model: LM, plan: StagePlan, *, remat: bool = True):
    def loss_fn(active: Params, frozen: Params, batch: dict) -> torch.Tensor:
        h, head_w, aux = stage_forward(model, frozen, active, batch, plan,
                                       remat=remat)
        return chunked_ce_loss(h, head_w, batch, model.cfg) + 0.01 * aux

    return loss_fn


def cached_stage_loss_fn(model: LM, plan: StagePlan, *, remat: bool = True):
    """Stage loss over cached prefix features: the batch carries ``h0``
    (the prefix's output) and ``aux0`` (its aux loss, a constant) beside
    the labels; no frozen tree is read."""
    def loss_fn(active: Params, batch: dict) -> torch.Tensor:
        h, head_w, aux = stage_forward_from_features(
            model, active, batch["h0"], batch["aux0"], plan, remat=remat)
        return chunked_ce_loss(h, head_w, batch, model.cfg) + 0.01 * aux

    return loss_fn


def init_stage_active(model: LM, params: Params, plan: StagePlan,
                      generator: torch.Generator) -> Tuple[Params, Params]:
    """(frozen, active) with a freshly drawn bfloat16 output module when the
    stage is not the last (the reference draws it in bfloat16 whatever the
    param dtype)."""
    frozen, active = split_stage_params(model, params, plan)
    if not plan.final:
        fac = ParamFactory(generator, model.device, torch.bfloat16)
        active["op"] = op_mod.lm_op_init(fac, model.cfg, plan.stage)
    return frozen, active


def _grads(loss_fn, leaves, template, *args):
    """(loss, gradients of the loss at ``leaves``); ``None`` where the loss
    does not reach a leaf."""
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = loss_fn(tree_unflatten(template, leaves), *args)
    return loss, list(torch.autograd.grad(loss, leaves, allow_unused=True))


def _local_step(loss_fn, leaves, template, args, opt: Optimizer,
                opt_state, clip_norm: float):
    """One local step on a pod's leaves (``loss_fn(tree, *args)``). A leaf
    the loss does not reach keeps its value when the optimizer's update of
    a zero gradient is zero (``opt.zero_grad_noop``: the reference's update
    is exactly zero), and takes a zero gradient otherwise."""
    loss, grads = _grads(loss_fn, leaves, template, *args)
    if not opt.zero_grad_noop:
        grads = [torch.zeros_like(leaf) if g is None else g
                 for g, leaf in zip(grads, leaves)]
    live = [i for i, g in enumerate(grads) if g is not None]
    # zero-padded keys keep tree_leaves order = the reference's leaf order
    g_tree = {f"{j:06d}": grads[i] for j, i in enumerate(live)}
    p_tree = {f"{j:06d}": leaves[i].detach() for j, i in enumerate(live)}
    del grads
    if opt_state is None:
        opt_state = opt.init(p_tree)
    g_tree, _ = clip_by_global_norm(g_tree, clip_norm)
    ups, opt_state = opt.update(g_tree, opt_state, p_tree)
    del g_tree
    new = apply_updates(p_tree, ups)
    out = [leaf.detach() for leaf in leaves]
    for j, i in enumerate(live):
        out[i] = new[f"{j:06d}"]
    return out, opt_state, loss.detach()


def fed_round(loss_fn, active: Params, args: tuple, batch: dict,
              weights: torch.Tensor, local_opt: Optimizer, *, num_pods: int,
              local_steps: int, clip_norm: float):
    """The pod loop of one federated round: each pod trains from ``active``
    for ``local_steps`` clipped steps of ``loss_fn(tree, *args, b)`` on its
    minibatches ``b = batch[k][pod, step]``, and the Eq. 1 fold averages
    the pods leaf by leaf in f32 (w = weights / sum(weights)) and casts
    back. Returns (new_active, {"loss": sum_p w_p * mean loss of pod p})."""
    w = (weights / torch.sum(weights)).float()
    start = tree_leaves(active)
    pods, losses = [], []
    for pod in range(num_pods):
        # detached views, not copies: a step writes no leaf in place (its
        # update makes new tensors), so the pods share the start and a
        # full-width block is not held twice (deepseek-v2's MoE block:
        # 9 GB)
        leaves = [leaf.detach() for leaf in start]
        opt_state, step_losses = None, []
        for s in range(local_steps):
            b = {k: v[pod, s] for k, v in batch.items()}
            leaves, opt_state, loss = _local_step(
                loss_fn, leaves, active, args + (b,), local_opt, opt_state,
                clip_norm)
            step_losses.append(loss)
        pods.append(leaves)
        losses.append(torch.stack(step_losses).mean())
    new = []
    for i, leaf in enumerate(start):
        acc = w[0] * pods[0][i].float()
        pods[0][i] = None
        for p in range(1, num_pods):
            acc = acc + w[p] * pods[p][i].float()
            pods[p][i] = None
        new.append(acc.to(leaf.dtype))
    loss = torch.sum(w * torch.stack(losses))
    return tree_unflatten(active, new), {"loss": loss}


def make_fed_round_step(model: LM, plan: StagePlan, local_opt: Optimizer, *,
                        num_pods: int, local_steps: int, remat: bool = True,
                        clip_norm: float = 1.0):
    """One federated round (Eq. 1) with pods as cross-silo clients.

    ``round_step(active, frozen, batch, weights)``: batch leaves are
    [num_pods, local_steps, ...]; weights [num_pods]. Each pod trains from
    ``active`` for ``local_steps`` clipped SGD steps; the new
    active tree is ``sum_p w_p * pod_p`` in f32, cast back per leaf, with
    w = weights / sum(weights). Returns (new_active, {"loss": sum_p w_p *
    mean local loss of pod p})."""
    loss_fn = stage_loss_fn(model, plan, remat=remat)

    def round_step(active: Params, frozen: Params, batch: dict,
                   weights: torch.Tensor):
        return fed_round(loss_fn, active, (frozen,), batch, weights,
                         local_opt, num_pods=num_pods,
                         local_steps=local_steps, clip_norm=clip_norm)

    return round_step


class TrainState(NamedTuple):
    active: Params
    frozen: Params
    opt_state: Any
    step: Any


def make_train_step(model: LM, plan: StagePlan, optimizer: Optimizer, *,
                    remat: bool = True, clip_norm: float = 1.0):
    """Centralized (single-cohort) stage step: ``step(state, batch)`` returns
    (new TrainState, {"loss", "grad_norm"}). ``state.opt_state`` covers the
    whole active tree (``optimizer.init(active)``), so a leaf the loss does
    not reach takes a zero gradient, as it does in the reference."""
    loss_fn = stage_loss_fn(model, plan, remat=remat)

    def step(state: TrainState, batch: dict):
        leaves = [leaf.detach() for leaf in tree_leaves(state.active)]
        loss, grads = _grads(loss_fn, leaves, state.active, state.frozen,
                             batch)
        grads = tree_unflatten(state.active, [
            torch.zeros_like(leaf) if g is None else g
            for g, leaf in zip(grads, leaves)])
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        ups, opt_state = optimizer.update(grads, state.opt_state,
                                          state.active)
        active = apply_updates(state.active, ups)
        return (TrainState(active, state.frozen, opt_state, state.step + 1),
                {"loss": loss.detach(), "grad_norm": gnorm})

    return step
