"""Progressive stage training for the CNN testbed (paper §IV-A; counterpart
of ``repro/core/freezing_cnn.py``).

The stage-t submodel is [stem?, stages 0..t, output module]; suffix stages
do not exist yet (model growth). The frozen prefix runs in eval mode (BN
running stats) without gradient; only stage t (+ stem at t=0) and the
output module are differentiated and optimized.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import output_module as op_mod
from repro_torch.models.cnn import CNN, softmax_xent
from repro_torch.models.module import ParamFactory, Params


def split_cnn_params(model: CNN, params: Params, stage: int
                     ) -> Tuple[Params, Params]:
    n_stages = len(model.cfg.stage_sizes)
    frozen: Params = {"stages": {}}
    active: Params = {"stages": {}}
    if model.cfg.kind == "resnet":
        (active if stage == 0 else frozen)["stem"] = params["stem"]
    for i in range(stage):
        frozen["stages"][f"stage{i}"] = params["stages"][f"stage{i}"]
    active["stages"][f"stage{stage}"] = params["stages"][f"stage{stage}"]
    if stage == n_stages - 1:
        active["fc"] = params["fc"]
    return frozen, active


def merge_cnn_params(model: CNN, params: Params, stage: int,
                     active: Params) -> Params:
    new = dict(params)
    new["stages"] = dict(params["stages"])
    if "stem" in active:
        new["stem"] = active["stem"]
    new["stages"][f"stage{stage}"] = active["stages"][f"stage{stage}"]
    if "fc" in active:
        new["fc"] = active["fc"]
    return new


def init_cnn_stage_active(model: CNN, params: Params, stage: int,
                          generator: torch.Generator, *,
                          op_kind: str = "conv") -> Tuple[Params, Params]:
    """op_kind: conv (paper) | fc_only (ablation) | none (final stage).
    The output module is drawn from ``generator`` onto the model's
    device."""
    frozen, active = split_cnn_params(model, params, stage)
    if stage < len(model.cfg.stage_sizes) - 1:
        fac = ParamFactory(generator, model.device)
        if op_kind == "conv":
            active["op"] = op_mod.cnn_op_init(fac, model.cfg, stage)
        elif op_kind == "fc_only":
            active["op"] = op_mod.cnn_fc_only_init(fac, model.cfg, stage)
    return frozen, active


@torch.no_grad()
def cnn_prefix_features(model: CNN, frozen: Params, bn_state: Params,
                        x: torch.Tensor, stage: int) -> torch.Tensor:
    """Forward of the frozen prefix only (stem + stages [0, stage)), eval
    mode, no gradient. Within a stage the prefix params and its BN running
    stats are fixed, so this is a pure function of ``x`` — the round engine
    computes it once per (client, stage) and caches it. Stage 0 has no
    frozen prefix: the identity is returned."""
    if stage == 0:
        return x
    h = x
    if model.cfg.kind == "resnet":
        h, _ = model.stem(frozen, bn_state, h, train=False)
    h, _ = model.run_stages(frozen, bn_state, h, 0, stage, train=False)
    return h


def cnn_stage_forward_from_features(model: CNN, active: Params,
                                    bn_state: Params, h: torch.Tensor,
                                    stage: int, *, op_kind: str = "conv",
                                    train: bool = True):
    """Active-suffix forward: consumes frozen-prefix features (or raw
    images at stage 0) and runs the active stage (+ stem at stage 0) and the
    head / output module. ``cnn_stage_forward`` composes prefix and suffix,
    so cached-feature training equals full recompute by construction."""
    cfg = model.cfg
    n_stages = len(cfg.stage_sizes)
    if stage == 0 and cfg.kind == "resnet":
        h, bn_state = model.stem(active, bn_state, h, train=train)
    h, bn_state = model.run_stages(active, bn_state, h, stage, stage + 1,
                                   train=train)
    if stage == n_stages - 1:
        logits = model.head(active, h)
    elif op_kind == "fc_only":
        logits = op_mod.cnn_fc_only_apply(active["op"], h)
    else:
        logits = op_mod.cnn_op_apply(active["op"], h, cfg, stage)
    return logits, bn_state


def cnn_stage_forward(model: CNN, frozen: Params, active: Params,
                      bn_state: Params, x: torch.Tensor, stage: int, *,
                      op_kind: str = "conv", train: bool = True):
    h = cnn_prefix_features(model, frozen, bn_state, x, stage)
    return cnn_stage_forward_from_features(model, active, bn_state, h, stage,
                                           op_kind=op_kind, train=train)


def cnn_stage_loss_fn(model: CNN, stage: int, *, op_kind: str = "conv"):
    def loss_fn(active, frozen, bn_state, batch):
        logits, new_state = cnn_stage_forward(model, frozen, active, bn_state,
                                              batch["x"], stage,
                                              op_kind=op_kind)
        return softmax_xent(logits, batch["y"]), new_state

    return loss_fn


def cnn_cached_stage_loss_fn(model: CNN, stage: int, *, op_kind: str = "conv"):
    """Stage loss over pre-extracted frozen-prefix features: ``batch["x"]``
    holds cached activations instead of images; the frozen tree is unused."""
    def loss_fn(active, frozen, bn_state, batch):
        logits, new_state = cnn_stage_forward_from_features(
            model, active, bn_state, batch["x"], stage, op_kind=op_kind)
        return softmax_xent(logits, batch["y"]), new_state

    return loss_fn
