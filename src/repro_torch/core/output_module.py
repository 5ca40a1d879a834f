"""Position-preserving output modules (paper §IV-A; counterpart of
``repro/core/output_module.py``).

The block being trained sees a stage-appropriate downstream:

* CNNs: each not-yet-trained stage is emulated by one stride-matched conv
  layer, then a global pool and an FC head;
* LMs: one slim proxy layer per remaining block (the arch's own attention,
  a d_ff = d_model MLP), then a norm and a stage-local LM head.

``op_overhead`` is the LM output module's share of a stage's memory and
FLOPs under the memory model (the paper reports 2.8% and 7.3%).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import memory_model as mm
from repro_torch.models.layers import (conv2d, conv2d_init, dense,
                                       dense_init, norm, norm_init)
from repro_torch.models.module import (ParamFactory, Params, init_stack,
                                       tree_leaves)


def _proxy_cfg(cfg):
    """The slim proxy layer's config: the arch's attention geometry, a
    d_ff = d_model MLP."""
    return dataclasses.replace(cfg, d_ff=cfg.d_model, attention="gqa",
                               num_experts=0, num_shared_experts=0,
                               experts_per_token=0)


def lm_op_init(fac: ParamFactory, cfg, stage: int) -> Params:
    """Output module for stage t: (T - t - 1) proxy layers + norm + head."""
    from repro_torch.models.transformer import layer_init

    pcfg = _proxy_cfg(cfg)
    n_proxy = max(cfg.num_freeze_blocks - stage - 1, 0)
    p: Params = {}
    if n_proxy:
        p["proxy"] = init_stack(fac, n_proxy,
                                lambda f: layer_init(f, pcfg, "attn_mlp"))
    p["norm"] = norm_init(fac, cfg.d_model, cfg.norm)
    p["head"] = dense_init(fac, cfg.d_model, cfg.vocab_size)
    return p


def lm_op_hidden(p: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    """Proxy layers + norm (the head is applied by the chunked CE loss)."""
    from repro_torch.models.transformer import layer_apply, layer_at

    pcfg = _proxy_cfg(cfg)
    if "proxy" in p:
        for i in range(tree_leaves(p["proxy"])[0].shape[0]):
            h, _ = layer_apply(layer_at(p["proxy"], i), h, pcfg, "attn_mlp",
                               causal=not cfg.is_encoder_only)
    return norm(p["norm"], h, cfg.norm, cfg.norm_eps)


def lm_op_apply(p: Params, h: torch.Tensor, cfg) -> torch.Tensor:
    """Proxy layers, norm and head: [B, S, V] logits."""
    return dense(p["head"], lm_op_hidden(p, h, cfg))


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


def op_overhead(cfg, stage: int, batch: int, seq: int) -> dict:
    """The stage-``stage`` output module's share of the stage's memory
    (its params at the param dtype) and FLOPs (the slim proxies' forward
    and backward), under ``core/memory_model.py``."""
    n_op = max(cfg.num_freeze_blocks - stage - 1, 0)
    op_params = n_op * mm._proxy_layer_params(cfg) \
        + cfg.d_model * cfg.vocab_size
    op_flops = n_op * mm.layer_fwd_flops_per_token(cfg, "attn_mlp", seq) \
        * 0.5 * batch * seq * 3
    stage_mem = mm.stage_memory_bytes(cfg, stage, batch, seq)["total"]
    stage_fl = mm.stage_flops(cfg, stage, batch, seq)["total"]
    return {"mem_fraction": op_params * mm.BYTES[cfg.param_dtype] / stage_mem,
            "flops_fraction": op_flops / stage_fl}
