"""Kernels of the port: CUDA sources in ``csrc/``, their wrappers, plain
versions (``ref.py``) and the dispatch between them (``ops.py``)."""
