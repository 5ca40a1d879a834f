"""Carry weights between the JAX package and the port.

The JAX package's ``(params, state)`` are nested dicts of arrays; the
port's are nested dicts of tensors with the same keys, shapes and layouts
(conv weights stay HWIO). Converting is therefore a dtype and device copy,
done leaf by leaf in ``leaf_to_torch`` / ``leaf_to_numpy``: a later layout
change of the port changes those two functions and nothing else.

bfloat16 crosses bit for bit through a ``uint16`` view: numpy has no
bfloat16 of its own, the JAX package's arrays carry ``ml_dtypes.bfloat16``,
which ``torch.as_tensor`` cannot take. ``ml_dtypes`` is imported only when
a bfloat16 leaf is handed back to numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.module import tree_map


def leaf_to_torch(leaf, device) -> torch.Tensor:
    arr = np.array(leaf, copy=True)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def leaf_to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_torch(tree, device="cpu"):
    """A tree of numpy (or numpy-convertible) arrays as the port's tree of
    tensors on ``device``."""
    return tree_map(lambda x: leaf_to_torch(x, device), tree)


def to_numpy(tree):
    """The port's tree of tensors as a tree of numpy arrays (the JAX
    package's layout)."""
    return tree_map(leaf_to_numpy, tree)
