"""Parameter-tree conventions (counterpart of ``repro/models/module.py``).

Params and state are nested dicts of tensors. Leaves iterate in SORTED key
order at every level — the order ``jax.tree.leaves`` uses for dicts — so a
flattened tree (pace-controller snapshots, error-feedback rows, top-k
payloads) is laid out exactly as the reference lays it out.

``ParamFactory`` (the reference's ``PFac``) draws initial values from a
caller-seeded ``torch.Generator``, on the generator's device, in an
explicit dtype. ``jax.random`` streams cannot be reproduced, so parity
tests carry the reference's initial params across with ``convert.py``.
``init_stack`` and ``slice_stack`` give the LM's stacked layers: every leaf
of a stack has a leading [n_layers] dim, as ``jax.lax.scan`` wants it in
the reference.
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


def tree_paths(tree, prefix: tuple = ()) -> List[Tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree_util.tree_flatten_with_path``'s
    order and naming, as the reference's ``tree_paths`` gives them: a dict
    key stands for itself (keys sorted), a list or tuple index is
    ``"[i]"``, and None holds no leaf."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in tree_paths(v, prefix + (f"[{i}]",))]
    if tree is None:
        return []
    return [(prefix, tree)]


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


def param_bytes(tree) -> int:
    return sum(int(leaf.numel()) * leaf.element_size()
               for leaf in tree_leaves(tree))


def cast_tree(tree, dtype: torch.dtype):
    """Cast the floating leaves to ``dtype``; other leaves stay as they
    are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


class ParamFactory:
    """Creates parameters on ``device`` in ``dtype`` from ``generator``.

    Values are drawn on the generator's device (a CPU generator makes the
    values independent of ``device``; a CUDA generator draws a model too
    large for the host straight on the card) and moved to ``device``.
    ``stack=n`` prepends a [n] dim to every parameter, with each layer's
    fan-in unchanged (``init_stack``). On the meta device nothing is drawn
    and ``generator`` may be None: the tree carries shapes and dtypes only,
    as the reference's ``jax.eval_shape`` of an init does."""

    def __init__(self, generator: torch.Generator, device="cpu",
                 dtype=torch.float32, stack: int = 0):
        self.generator = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.stack = stack

    def param(self, shape: Tuple[int, ...], *, init: str = "normal",
              scale: float = 1.0, fan_in: Optional[int] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``normal`` draws N(0, (scale / sqrt(fan_in))^2) with the
        reference's default fan-in (``shape[0]`` for matrices), ``embed``
        N(0, scale^2), as ``PFac.param`` does. ``dtype`` overrides the
        factory's (Mamba2 keeps A_log, D and dt_bias in float32)."""
        dtype = self.dtype if dtype is None else dtype
        full = ((self.stack,) if self.stack else ()) + tuple(shape)
        if self.device.type == "meta":
            return torch.empty(full, dtype=dtype, device="meta")
        if init == "zeros":
            return torch.zeros(full, dtype=dtype, device=self.device)
        if init == "ones":
            return torch.ones(full, dtype=dtype, device=self.device)
        if init == "normal":
            fi = fan_in if fan_in is not None else (
                shape[0] if len(shape) > 1 else shape[-1])
            std = scale / math.sqrt(max(fi, 1))
        elif init == "embed":
            std = scale
        else:
            raise ValueError(f"unknown init {init}")
        t = torch.randn(full, generator=self.generator,
                        device=self.generator.device, dtype=torch.float32)
        return t.mul_(std).to(dtype).to(self.device)


def init_stack(fac: ParamFactory, n: int,
               layer_init: Callable[[ParamFactory], Params]) -> Params:
    """``n`` stacked copies of a layer: every leaf gets a leading [n] dim."""
    return layer_init(ParamFactory(fac.generator, fac.device, fac.dtype,
                                   stack=n))


def slice_stack(stacked: Params, lo: int, hi: int) -> Params:
    """Layers [lo, hi) of every stacked leaf (views, no copy)."""
    return tree_map(lambda x: x[lo:hi], stacked)
