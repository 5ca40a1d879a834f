"""Parameter-tree conventions (counterpart of ``repro/models/module.py``).

Params and state are nested dicts of tensors. Leaves iterate in SORTED key
order at every level — the order ``jax.tree.leaves`` uses for dicts — so a
flattened tree (pace-controller snapshots, error-feedback rows, top-k
payloads) is laid out exactly as the reference lays it out.

``ParamFactory`` draws initial values from a caller-seeded
``torch.Generator``. ``jax.random`` streams cannot be reproduced, so parity
tests carry the reference's initial params across with ``convert.py``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

Params = Dict[str, Any]


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (``jax.tree.leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(template, leaves: Sequence) -> Params:
    """Rebuild ``template``'s structure from leaves in ``tree_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def param_count(tree) -> int:
    return sum(int(leaf.numel()) for leaf in tree_leaves(tree))


class ParamFactory:
    """Creates parameters on ``device`` from ``generator`` (a CPU
    ``torch.Generator``, so the values do not depend on the device)."""

    def __init__(self, generator: torch.Generator, device="cpu",
                 dtype=torch.float32):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype

    def param(self, shape: Tuple[int, ...], *, init: str = "normal",
              scale: float = 1.0, fan_in: Optional[int] = None
              ) -> torch.Tensor:
        """``normal`` draws N(0, (scale / sqrt(fan_in))^2) with the
        reference's default fan-in (``shape[0]`` for matrices), as
        ``PFac.param`` does."""
        if init == "zeros":
            t = torch.zeros(shape, dtype=self.dtype)
        elif init == "ones":
            t = torch.ones(shape, dtype=self.dtype)
        elif init == "normal":
            fi = fan_in if fan_in is not None else (
                shape[0] if len(shape) > 1 else shape[-1])
            std = scale / math.sqrt(max(fi, 1))
            t = torch.randn(shape, generator=self.generator,
                            dtype=torch.float32).mul_(std).to(self.dtype)
        else:
            raise ValueError(f"unknown init {init}")
        return t.to(self.device)
