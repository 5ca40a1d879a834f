"""Mixture-of-Experts FFN (counterpart of ``repro/models/moe.py``).

The GShard dual-einsum formulation with a capacity factor, chunked over
the sequence (a loop over ``MOE_CHUNK``-token chunks, the reference's
``lax.scan``), so the dispatch and combine one-hots stay [B, chunk, E, C].
Each chunk routes its tokens with a float32 router, keeps the top k
experts of each token, and gives every (token, choice) a slot in its
expert's queue of ``C`` slots: earlier choices in the flattened
(token, choice) order win, and a choice past the capacity is dropped (its
slot one-hot is a row of zeros, as ``jax.nn.one_hot`` gives for an index
past its width). The shared experts run once, on the whole sequence.

Where a literal translation of the reference would part from it:
``torch.topk`` makes no promise on ties, so top-k is the first k of a
stable descending sort (equal probabilities resolve to the lower expert,
as ``lax.top_k`` does); ``F.one_hot`` raises past its width, so the slot
one-hot compares with ``arange(C)``; the expert weights are drawn with
their own fan-in (d, d, ff), not the stacked leading dim. The FFNs' silu
is ``layers.silu``, in the reference's bf16 roundings: ``F.silu`` rounds
once and put the reduced deepseek-v2 layer's bf16 output 0.047 from the
reference's, past the reference's own bf16-f32 spread of 0.026
(``tests/test_torch_moe.py``); the expert hidden holds only tokens x k x
capacity-factor rows, so the extra passes cost little.

``moe_decode`` treats the batch as one token group (one token a sequence)
at twice the capacity factor, as the reference does; lower batch rows win
a slot, and the reference's drops are reproduced, not avoided.

The MoE FFN calls no kernel, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.models.layers import activation, dense, dense_init, silu
from repro_torch.models.module import ParamFactory, Params

MOE_CHUNK = 128  # sequence chunk for dispatch (divides all assigned seq lens)


def moe_init(fac: ParamFactory, cfg) -> Params:
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p: Params = {
        "router": fac.param((d, E), init="normal", dtype=torch.float32),
        "w_gate": fac.param((E, d, ff), init="normal", fan_in=d),
        "w_up": fac.param((E, d, ff), init="normal", fan_in=d),
        "w_down": fac.param((E, ff, d), init="normal", fan_in=ff),
    }
    if cfg.num_shared_experts > 0:
        sff = cfg.num_shared_experts * ff
        p["shared_gate"] = dense_init(fac, d, sff)
        p["shared_up"] = dense_init(fac, d, sff)
        p["shared_down"] = dense_init(fac, sff, d)
    return p


def _capacity(chunk_tokens: int, cfg) -> int:
    c = int(chunk_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(c, 1)


def _dispatch_combine(x: torch.Tensor, p: Params, cfg
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GShard top-k dispatch for one chunk. x: [B, Sc, d].

    Returns (dispatch [B, Sc, E, C] one-hot, combine [B, Sc, E, C], both
    in x's dtype, and the f32 aux loss)."""
    B, Sc, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = _capacity(Sc, cfg)
    logits = x.float() @ p["router"].float()  # [B, Sc, E]
    probs = torch.softmax(logits, dim=-1)
    vals, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = vals[..., :k], order[..., :k]  # [B, Sc, k]
    experts = torch.arange(E, device=x.device)
    onehot = (idx[..., None] == experts).float()  # [B, Sc, k, E]
    # position of each (token, choice) within its expert queue: cumulate
    # over the flattened (Sc*k) token-choice order (earlier tokens win)
    flat = onehot.reshape(B, Sc * k, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(B, Sc, k, E)
    keep = onehot * (pos < C).float()
    where = torch.sum(pos * onehot, dim=-1).to(torch.int32)  # [B, Sc, k]
    slot = (where[..., None] == torch.arange(C, device=x.device,
                                             dtype=torch.int32)).float()
    disp = torch.einsum("bske,bskc->bsec", keep, slot)
    comb = torch.einsum("bske,bskc,bsk->bsec", keep, slot, gate_vals)
    # expert-level load-balancing aux loss (Switch-style)
    me = torch.mean(probs, dim=(0, 1))  # mean router prob per expert
    ce = torch.mean(onehot.sum(2), dim=(0, 1))  # fraction routed per expert
    aux = torch.sum(me * ce) * (E / k)
    return disp.to(x.dtype), comb.to(x.dtype), aux


def _act(cfg):
    """The FFN activation, silu in the reference's roundings."""
    return silu if cfg.mlp_activation == "silu" else activation(
        cfg.mlp_activation)


def _expert_ffn(p: Params, xin: torch.Tensor, cfg) -> torch.Tensor:
    """xin: [B, E, C, d] -> [B, E, C, d]; batched over experts."""
    act = _act(cfg)
    g = torch.einsum("becd,edf->becf", xin, p["w_gate"].to(xin.dtype))
    u = torch.einsum("becd,edf->becf", xin, p["w_up"].to(xin.dtype))
    h = act(g) * u
    return torch.einsum("becf,efd->becd", h, p["w_down"].to(xin.dtype))


def _shared(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    act = _act(cfg)
    return dense(p["shared_down"],
                 act(dense(p["shared_gate"], x)) * dense(p["shared_up"], x))


def moe_forward(p: Params, x: torch.Tensor, cfg
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE FFN. x: [B, S, d] -> ([B, S, d], f32 aux loss scalar)."""
    B, S, d = x.shape
    chunk = min(MOE_CHUNK, S)
    assert S % chunk == 0, f"seq {S} not divisible by moe chunk {chunk}"
    n = S // chunk
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(n):
        xc = x[:, i * chunk:(i + 1) * chunk]
        disp, comb, aux = _dispatch_combine(xc, p, cfg)
        xin = torch.einsum("bsec,bsd->becd", disp, xc)
        out = _expert_ffn(p, xin, cfg)
        ys.append(torch.einsum("becd,bsec->bsd", out, comb))
        aux_total = aux_total + aux
    y = torch.cat(ys, dim=1)
    if cfg.num_shared_experts > 0:
        y = y + _shared(p, x, cfg)
    return y, aux_total / n


def moe_decode(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Decode-path MoE for a single token per sequence. x: [B, 1, d].

    The capacity-based GShard dispatch with the *batch* as the token group
    (one token a sequence), at twice the capacity factor."""
    B, _, d = x.shape
    dcfg = dataclasses.replace(cfg, capacity_factor=cfg.capacity_factor * 2)
    xt = x.reshape(1, B, d)  # [1, B (tokens), d]
    disp, comb, _ = _dispatch_combine(xt, p, dcfg)
    xin = torch.einsum("bsec,bsd->becd", disp, xt)
    out = _expert_ffn(p, xin, cfg)
    y = torch.einsum("becd,bsec->bsd", out, comb).reshape(B, 1, d)
    if cfg.num_shared_experts > 0:
        y = y + _shared(p, x, cfg)
    return y
