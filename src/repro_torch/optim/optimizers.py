"""Optimizers as functional transformations over nested dicts of tensors
(counterpart of ``repro/optim/optimizers.py``).

Each ``Optimizer`` is (init, update): ``update(grads, state, params)``
returns (updates, new_state), and updates are ADDED to params. Frozen
blocks never enter the optimizer — SmartFreeze splits the param tree
itself, so no masking is needed.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Union

import torch

from repro_torch.models.module import tree_leaves, tree_map

Schedule = Union[float, Callable[[int], float]]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple]


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

    return Optimizer(init, update)


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
