"""Learning-rate schedules, step -> lr (counterpart of
``repro/optim/schedules.py``). Each returns a 0-dim float32 tensor
computed in float32, op for op in the reference's order."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, max=1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return _f32(lr) * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                        0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return _f32(lr) * torch.where(s < warmup_steps, warm, cos)
    return f
