"""Position-preserving CNN output modules (paper §IV-A; counterpart of the
CNN part of ``repro/core/output_module.py``).

The block being trained sees a stage-appropriate downstream: each
not-yet-trained stage is emulated by one stride-matched conv layer, then a
global pool and an FC head.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import conv2d, conv2d_init
from repro_torch.models.module import ParamFactory, Params


def cnn_op_init(fac: ParamFactory, cnn_cfg, stage: int) -> Params:
    """One stride-2 conv per remaining stage, channel trajectory preserved."""
    chans = cnn_cfg.stage_channels
    p: Params = {"convs": {}}
    c_in = chans[stage]
    for i in range(stage + 1, len(chans)):
        p["convs"][f"c{i}"] = conv2d_init(fac, c_in, chans[i], 3)
        c_in = chans[i]
    p["fc"] = {"w": fac.param((c_in, cnn_cfg.num_classes)),
               "b": fac.param((cnn_cfg.num_classes,), init="zeros")}
    return p


def cnn_op_apply(p: Params, h: torch.Tensor, cnn_cfg, stage: int
                 ) -> torch.Tensor:
    for i in range(stage + 1, len(cnn_cfg.stage_channels)):
        stride = 2 if (cnn_cfg.kind == "resnet" and i > 0) or cnn_cfg.kind == "vgg" else 1
        h = torch.relu(conv2d(p["convs"][f"c{i}"], h, stride=stride))
    h = torch.mean(h, dim=(1, 2))
    return h @ p["fc"]["w"] + p["fc"]["b"]


def cnn_fc_only_init(fac: ParamFactory, cnn_cfg, stage: int) -> Params:
    """Ablation: naive FC-only output module (the paper shows it hurts)."""
    c = cnn_cfg.stage_channels[stage]
    return {"fc": {"w": fac.param((c, cnn_cfg.num_classes)),
                   "b": fac.param((cnn_cfg.num_classes,), init="zeros")}}


def cnn_fc_only_apply(p: Params, h: torch.Tensor) -> torch.Tensor:
    h = torch.mean(h, dim=(1, 2))
    return h @ p["fc"]["w"] + p["fc"]["b"]
