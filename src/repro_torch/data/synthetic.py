"""Synthetic data (numpy copy of ``repro/data/synthetic.py``): CIFAR-like
vision classification (per-class low-frequency prototypes plus Gaussian
noise, learnable by a CNN), LM token streams (Zipf tokens with a learnable
bigram rule) and the VLM and audio stubs' batches (patch embeddings or
frame features with random tokens and labels). Bitwise equal to the
reference for the same seed. ``input_specs`` gives the abstract inputs of
one step as tensors on the meta device, the counterpart of the
reference's ``ShapeDtypeStruct`` specs."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch


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
    """Concrete numpy batch, modality-aware. Audio: ``frames`` [batch, seq,
    frontend_dim] f32 and ``labels``. Vision: ``seq`` counts the
    ``num_image_tokens`` patch positions too, so ``tokens`` and ``labels``
    are [batch, seq - num_image_tokens] and ``patches`` [batch,
    num_image_tokens, frontend_dim]. The draws come in the reference's
    order (frames, labels; tokens, patches, labels)."""
    rng = np.random.RandomState(seed)
    if cfg.modality == "audio_stub":
        return {"frames": rng.randn(batch, seq, cfg.frontend_dim).astype(
                    np.float32),
                "labels": rng.randint(0, cfg.vocab_size, (batch, seq)).astype(
                    np.int32)}
    if cfg.modality == "vision_stub":
        nt = cfg.num_image_tokens
        st = seq - nt
        return {"tokens": rng.randint(0, cfg.vocab_size, (batch, st)).astype(
                    np.int32),
                "patches": rng.randn(batch, nt, cfg.frontend_dim).astype(
                    np.float32),
                "labels": rng.randint(0, cfg.vocab_size, (batch, st)).astype(
                    np.int32)}
    return SyntheticLM(cfg.vocab_size).sample(batch, seq, seed)


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg, shape, *, num_pods: int = 1, local_steps: int = 1
                ) -> Dict[str, torch.Tensor]:
    """Abstract inputs (meta tensors, no storage) for one step at ``shape``:
    train is the federated round's [num_pods, local_steps, per-pod batch,
    ...] layout, prefill [batch, seq] tokens, decode one [batch, 1] token
    (the KV cache is state, not input). An encoder-only audio arch has no
    decode step and raises ``ValueError``."""
    B, S = shape.global_batch, shape.seq_len

    def tok_specs(b, lead=()):
        if cfg.modality == "audio_stub":
            return {"frames": _spec(lead + (b, S, cfg.frontend_dim),
                                    torch.float32),
                    "labels": _spec(lead + (b, S), torch.int32)}
        if cfg.modality == "vision_stub":
            nt = cfg.num_image_tokens
            return {"tokens": _spec(lead + (b, S - nt), torch.int32),
                    "patches": _spec(lead + (b, nt, cfg.frontend_dim),
                                     torch.float32),
                    "labels": _spec(lead + (b, S - nt), torch.int32)}
        return {"tokens": _spec(lead + (b, S), torch.int32),
                "labels": _spec(lead + (b, S), torch.int32)}

    if shape.kind == "train":
        return tok_specs(B // num_pods, lead=(num_pods, local_steps))
    if shape.kind == "prefill":
        return tok_specs(B)
    if cfg.modality == "audio_stub":
        raise ValueError("encoder-only arch has no decode step")
    return {"tokens": _spec((B, 1), torch.int32)}
