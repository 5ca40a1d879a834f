"""CNNs of the paper's testbed: ResNet10/18, VGG11_bn/VGG16_bn
(counterpart of ``repro/models/cnn.py``).

The model exposes the decomposed interface SmartFreeze drives (stem /
run_stages(lo, hi) / head). BatchNorm running stats live in a separate
``state`` tree, which FedAvg aggregates like parameters. Tensors are NHWC
and conv weights HWIO, as in the reference, so a flattened leaf holds the
same values in the same order in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import resolve_device
from repro_torch.models.layers import (batchnorm, batchnorm_init, conv2d,
                                       conv2d_init)
from repro_torch.models.module import ParamFactory, Params


@dataclass(frozen=True)
class CNNConfig:
    name: str
    kind: str  # resnet | vgg
    num_classes: int = 10
    # resnet: blocks per stage; vgg: convs per stage
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)
    stage_channels: Tuple[int, ...] = (64, 128, 256, 512)
    in_channels: int = 3
    num_freeze_blocks: int = 4
    # BN running-stat momentum; 0.6 for the reason the reference gives:
    # a federated round runs only a few minibatches per client, and stats
    # anchored at their (0, 1) init leave eval mode degenerate.
    bn_momentum: float = 0.6

    def block_boundaries(self) -> Tuple[int, ...]:
        """SmartFreeze blocks == network stages (ResNet-18 -> 4 blocks)."""
        return tuple(range(len(self.stage_sizes) + 1))


RESNET10 = CNNConfig("resnet10", "resnet", stage_sizes=(1, 1, 1, 1))
RESNET18 = CNNConfig("resnet18", "resnet", stage_sizes=(2, 2, 2, 2))
VGG11 = CNNConfig("vgg11_bn", "vgg", stage_sizes=(1, 1, 2, 2, 2),
                  stage_channels=(64, 128, 256, 512, 512))
VGG16 = CNNConfig("vgg16_bn", "vgg", stage_sizes=(2, 2, 3, 3, 3),
                  stage_channels=(64, 128, 256, 512, 512))

CNN_REGISTRY = {c.name: c for c in (RESNET10, RESNET18, VGG11, VGG16)}


def softmax_xent(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32 — the loss of the CNN testbed."""
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, y.long()[:, None])[:, 0]
    return torch.mean(logz - gold)


# ---------------------------------------------------------------------------
# ResNet pieces
# ---------------------------------------------------------------------------


def _basic_block_init(fac: ParamFactory, c_in: int, c_out: int
                      ) -> Tuple[Params, Params]:
    p: Params = {}
    s: Params = {}
    p["conv1"] = conv2d_init(fac, c_in, c_out, 3, bias=False)
    p["bn1"], s["bn1"] = batchnorm_init(fac, c_out)
    p["conv2"] = conv2d_init(fac, c_out, c_out, 3, bias=False)
    p["bn2"], s["bn2"] = batchnorm_init(fac, c_out)
    if c_in != c_out:
        p["proj"] = conv2d_init(fac, c_in, c_out, 1, bias=False)
        p["bn_proj"], s["bn_proj"] = batchnorm_init(fac, c_out)
    return p, s


def _basic_block(p: Params, s: Params, x: torch.Tensor, stride: int, *,
                 train: bool, momentum: float = 0.6
                 ) -> Tuple[torch.Tensor, Params]:
    ns: Params = {}
    h = conv2d(p["conv1"], x, stride=stride)
    h, ns["bn1"] = batchnorm(p["bn1"], s["bn1"], h, train=train,
                             momentum=momentum)
    h = torch.relu(h)
    h = conv2d(p["conv2"], h)
    h, ns["bn2"] = batchnorm(p["bn2"], s["bn2"], h, train=train,
                             momentum=momentum)
    if "proj" in p:
        sc = conv2d(p["proj"], x, stride=stride)
        sc, ns["bn_proj"] = batchnorm(p["bn_proj"], s["bn_proj"], sc,
                                      train=train, momentum=momentum)
    else:
        sc = x if stride == 1 else x[:, ::stride, ::stride, :]
    return torch.relu(h + sc), ns


# ---------------------------------------------------------------------------
# CNN model
# ---------------------------------------------------------------------------


@dataclass
class CNN:
    """``device`` is where ``init`` places the params; it defaults to the
    card and raises when CUDA is absent (tests pass ``device="cpu"``)."""

    cfg: CNNConfig
    device: torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def init(self, generator: torch.Generator) -> Tuple[Params, Params]:
        return self.init_from(ParamFactory(generator, self.device))

    def init_from(self, fac: ParamFactory) -> Tuple[Params, Params]:
        """``init`` with the caller's factory (a factory of meta tensors
        gives the shapes without drawing a number)."""
        cfg = self.cfg
        p: Params = {}
        s: Params = {}
        if cfg.kind == "resnet":
            conv = conv2d_init(fac, cfg.in_channels, cfg.stage_channels[0], 3,
                               bias=False)
            bn_p, s["stem_bn"] = batchnorm_init(fac, cfg.stage_channels[0])
            p["stem"] = {"conv": conv, "bn": bn_p}
        stages: Params = {}
        sstates: Params = {}
        c_prev = cfg.stage_channels[0] if cfg.kind == "resnet" else cfg.in_channels
        for i, (nb, ch) in enumerate(zip(cfg.stage_sizes, cfg.stage_channels)):
            blocks: Params = {}
            bstates: Params = {}
            for j in range(nb):
                if cfg.kind == "resnet":
                    bp, bs = _basic_block_init(fac, c_prev if j == 0 else ch, ch)
                else:  # vgg: conv-bn-relu
                    bp = {"conv": conv2d_init(fac, c_prev if j == 0 else ch, ch, 3)}
                    bp["bn"], bs0 = batchnorm_init(fac, ch)
                    bs = {"bn": bs0}
                blocks[f"b{j}"] = bp
                bstates[f"b{j}"] = bs
            stages[f"stage{i}"] = blocks
            sstates[f"stage{i}"] = bstates
            c_prev = ch
        p["stages"] = stages
        s["stages"] = sstates
        p["fc"] = {"w": fac.param((cfg.stage_channels[-1], cfg.num_classes)),
                   "b": fac.param((cfg.num_classes,), init="zeros")}
        return p, s

    # ----- stage-decomposed forward -----

    def stem(self, params: Params, state: Params, x: torch.Tensor, *,
             train: bool):
        if self.cfg.kind != "resnet":
            return x, state
        h = conv2d(params["stem"]["conv"], x)
        h, bn = batchnorm(params["stem"]["bn"], state["stem_bn"], h,
                          train=train, momentum=self.cfg.bn_momentum)
        new_state = dict(state)
        new_state["stem_bn"] = bn
        return torch.relu(h), new_state

    def run_stages(self, params: Params, state: Params, h: torch.Tensor,
                   lo: int, hi: int, *, train: bool):
        cfg = self.cfg
        new_state = dict(state)
        new_stages = dict(state["stages"])
        for i in range(lo, hi):
            blocks = params["stages"][f"stage{i}"]
            bstates = state["stages"][f"stage{i}"]
            nbs: Params = {}
            for j in range(cfg.stage_sizes[i]):
                bp, bs = blocks[f"b{j}"], bstates[f"b{j}"]
                if cfg.kind == "resnet":
                    stride = 2 if (j == 0 and i > 0) else 1
                    h, ns = _basic_block(bp, bs, h, stride, train=train,
                                         momentum=cfg.bn_momentum)
                else:
                    h = conv2d(bp["conv"], h)
                    h, bn = batchnorm(bp["bn"], bs["bn"], h, train=train,
                                      momentum=cfg.bn_momentum)
                    h = torch.relu(h)
                    ns = {"bn": bn}
                nbs[f"b{j}"] = ns
            if cfg.kind == "vgg":  # 2x2 max-pool after each vgg stage
                h = F.max_pool2d(h.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            new_stages[f"stage{i}"] = nbs
        new_state["stages"] = new_stages
        return h, new_state

    def head(self, params: Params, h: torch.Tensor) -> torch.Tensor:
        h = torch.mean(h, dim=(1, 2))  # global average pool
        return h @ params["fc"]["w"] + params["fc"]["b"]

    def apply(self, params: Params, state: Params, x: torch.Tensor, *,
              train: bool = True):
        h, state = self.stem(params, state, x, train=train)
        h, state = self.run_stages(params, state, h, 0,
                                   len(self.cfg.stage_sizes), train=train)
        return self.head(params, h), state

    def loss(self, params: Params, state: Params, batch, *,
             train: bool = True):
        logits, new_state = self.apply(params, state, batch["x"], train=train)
        return softmax_xent(logits, batch["y"]), new_state

    def stage_output_channels(self, stage: int) -> int:
        return self.cfg.stage_channels[stage]


def build_cnn(name: str, num_classes: int = 10, device="cuda") -> CNN:
    cfg = dataclasses.replace(CNN_REGISTRY[name], num_classes=num_classes)
    return CNN(cfg, device=device)
