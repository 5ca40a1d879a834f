"""SmartFreeze in PyTorch: the port of the JAX package ``repro`` to CUDA.

The layout mirrors ``repro`` module for module (``optim/``, ``models/``,
``core/``, ``core/selector/``, ``data/``, ``fl/``, ``kernels/``), so each
function has its counterpart at the same path. This package never imports
``jax`` or ``repro``; its tests import both and compare them through numpy.

Parameter trees are nested dicts of tensors whose leaves iterate in sorted
key order (``models.module.tree_leaves``), the order ``jax.tree.leaves``
uses, so flattened leaves, error-feedback rows and uplink payloads line up
with the reference byte for byte.
"""
