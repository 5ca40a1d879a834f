"""Optimizers as functional transformations over nested dicts of tensors
(counterpart of ``repro/optim/optimizers.py``).

Each ``Optimizer`` is (init, update): ``update(grads, state, params)``
returns (updates, new_state), and updates are ADDED to params. AdamW keeps
f32 moments and applies its update in f32 before the cast back, so bf16
params train stably. Frozen blocks never enter the optimizer — SmartFreeze
splits the param tree itself, so no masking is needed.

``zero_grad_noop`` says that a zero gradient gives a zero update whatever
the state (SGD, momentum from a zero start): a trainer may then skip a
leaf the loss does not reach instead of feeding it zeros
(``core/freezing.py``). AdamW's weight decay moves every leaf, so it
takes the zeros.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.models.module import tree_leaves, tree_map

Schedule = Union[float, Callable[[int], float]]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    zero_grad_noop: bool = False


def _lr(schedule: Schedule, step: int):
    return schedule(step) if callable(schedule) else schedule


def sgd(lr: Schedule) -> Optimizer:
    def init(params):
        return {"step": 0}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = _lr(lr, step)
        ups = tree_map(lambda g: -lr_t * g.float(), grads)
        return ups, {"step": step}

    return Optimizer(init, update, zero_grad_noop=True)


def momentum(lr: Schedule, beta: float = 0.9) -> Optimizer:
    def init(params):
        return {"step": 0,
                "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                               params)}

    def update(grads, state, params=None):
        step = state["step"] + 1
        mu = tree_map(lambda m, g: beta * m + g.float(), state["mu"], grads)
        lr_t = _lr(lr, step)
        ups = tree_map(lambda m: -lr_t * m, mu)
        return ups, {"step": step, "mu": mu}

    return Optimizer(init, update, zero_grad_noop=True)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments m and v, an integer step and the bias
    corrections 1 - b^step taken in f32, as the reference computes them."""
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)
        return {"step": 0, "m": tree_map(zeros, params),
                "v": tree_map(zeros, params)}

    def update(grads, state, params):
        step = state["step"] + 1
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_
                     + (1 - b2) * torch.square(g.float()), state["v"], grads)
        t = torch.tensor(step, dtype=torch.float32)
        c1 = 1 - b1 ** t
        c2 = 1 - b2 ** t
        lr_t = _lr(lr, step)

        def upd(m_, v_, p):  # c1, c2: 0-dim CPU tensors, scalars on a card
            return -lr_t * ((m_ / c1) / (torch.sqrt(v_ / c2) + eps)
                            + weight_decay * p.float())

        ups = tree_map(upd, m, v, params)
        return ups, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm
