"""Device resolution for the port's entry points (``CNN``, ``RoundEngine``,
``SmartFreezeServer``).

The entry points run on the card unless the caller asks for the CPU. A
CUDA device without CUDA raises: nothing carries on silently on the CPU.

The reference computes in full float32. PyTorch's cuDNN convolutions use
TF32 by default (``torch.backends.cudnn.allow_tf32`` is True), which keeps
about three decimal digits, so every entry point turns TF32 off for
convolutions and matrix products alike: f32 work stays f32. bf16 runs only
where a caller asks for it with ``compute_dtype="bfloat16"``
(``fl/engine.py:make_fused_round``), as in the reference.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``, with float32 math pinned to full
    precision. Raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
