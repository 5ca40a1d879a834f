"""Synthetic CIFAR-like vision data (numpy copy of
``repro/data/synthetic.py:SyntheticVision``): per-class low-frequency
prototypes plus Gaussian noise, learnable by a CNN. Bitwise equal to the
reference for the same seed."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np


@dataclass
class SyntheticVision:
    num_classes: int = 10
    image_size: int = 32
    noise: float = 0.35
    seed: int = 0

    def __post_init__(self):
        rng = np.random.RandomState(self.seed)
        base = rng.randn(self.num_classes, 8, 8, 3).astype(np.float32)
        self.protos = np.stack([
            np.kron(base[c], np.ones((4, 4, 1), np.float32))[:self.image_size, :self.image_size]
            for c in range(self.num_classes)])

    def sample(self, n: int, labels: Optional[np.ndarray] = None,
               seed: int = 0) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(seed)
        y = labels if labels is not None else rng.randint(0, self.num_classes, n)
        x = self.protos[y] + self.noise * rng.randn(n, self.image_size,
                                                    self.image_size, 3).astype(np.float32)
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}
