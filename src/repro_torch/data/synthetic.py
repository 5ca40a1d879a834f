"""Synthetic data (numpy copy of ``repro/data/synthetic.py``): CIFAR-like
vision classification (per-class low-frequency prototypes plus Gaussian
noise, learnable by a CNN) and LM token streams (Zipf tokens with a
learnable bigram rule). Bitwise equal to the reference for the same seed.
The VLM and audio batches and the dry-run ``input_specs`` are not ported
(ROADMAP A15)."""
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


@dataclass
class SyntheticLM:
    vocab_size: int
    seed: int = 0

    def sample(self, batch: int, seq: int, seed: int = 0) -> Dict[str, np.ndarray]:
        """Zipf-distributed tokens with a learnable bigram structure."""
        rng = np.random.RandomState(seed)
        v = self.vocab_size
        ranks = np.arange(1, v + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = rng.choice(v, size=(batch, seq + 1), p=probs).astype(np.int32)
        # every even position repeats (t-1 + 1) mod v
        toks[:, 2::2] = (toks[:, 1:-1:2] + 1) % v
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}


def make_lm_batch(cfg, batch: int, seq: int, seed: int = 0) -> Dict:
    """Concrete numpy token batch (text modality only)."""
    if cfg.modality != "text":
        raise NotImplementedError(f"modality {cfg.modality!r} is not ported "
                                  "(ROADMAP A15)")
    return SyntheticLM(cfg.vocab_size).sample(batch, seq, seed)
