"""CNN memory model — the paper's Eq. (4) for the vision testbed, and the
feature-cache admission ladder (counterpart of the CNN part of
``repro/core/memory_model.py``; plain arithmetic).

The byte counts model the simulated clients' device memory, not the card
the port runs on.
"""
from __future__ import annotations

from typing import Optional

# Feature-cache precision tiers in admission order. This slice ports only
# the f32 tier; the ladder and the per-dtype prices are kept whole so the
# admission arithmetic matches the reference's.
CACHE_TIERS = ("f32", "fp16", "int8")
CACHE_TIER_DTYPES = {"f32": "float32", "fp16": "float16", "int8": "int8"}
_CACHE_DTYPE_BYTES = {"float32": 4.0, "bfloat16": 2.0, "float16": 2.0,
                      "int8": 1.0}


def cache_tier_ladder(memory_bytes: float, requirement_fn,
                      tiers=CACHE_TIERS) -> Optional[str]:
    """First tier in ``tiers`` whose stage-plus-cache requirement
    (``requirement_fn(tier) -> bytes``) fits ``memory_bytes``; ``None``
    declines the cache (the client recomputes the frozen prefix)."""
    for tier in tiers:
        if memory_bytes >= requirement_fn(tier):
            return tier
    return None


def cnn_feature_cache_bytes(model, stage: int, num_samples: int,
                            image_size: int = 32,
                            dtype: str = "float32") -> float:
    """Bytes to hold a client shard's frozen-prefix activations: the
    feature map at the stage boundary, one per local sample, at ``dtype``.
    An int8 cache adds one f32 scale per (sample, channel)."""
    if stage <= 0:
        return 0.0
    cfg = model.cfg
    ch = cfg.stage_channels[stage - 1]
    if cfg.kind == "vgg":  # maxpool halves after every stage
        res = max(image_size // (2 ** stage), 1)
    else:  # resnet: stride-2 at each stage entry except stage 0
        res = max(image_size // (2 ** (stage - 1)), 1)
    total = float(num_samples) * res * res * ch * _CACHE_DTYPE_BYTES[dtype]
    if dtype == "int8":
        total += float(num_samples) * ch * 4.0
    return total


def cnn_stage_memory_bytes(model, stage: int, batch_size: int,
                           image_size: int = 32, *,
                           cache_samples: int = 0,
                           cache_dtype: str = "float32") -> float:
    """Eq. (4) for the CNN testbed (fp32). ``cache_samples`` adds the
    client's frozen-prefix feature cache at ``cache_dtype``, which the
    server uses to decline the cache on memory-poor clients."""
    cfg = model.cfg
    res = image_size
    act = 0.0
    max_act = 0.0
    params = 0.0
    for i, (nb, ch) in enumerate(zip(cfg.stage_sizes, cfg.stage_channels)):
        r = res // (2 ** i) if cfg.kind == "vgg" else max(res // (2 ** max(i, 0)), 4)
        a = batch_size * r * r * ch * 4.0 * nb * 2  # convs per stage
        max_act = max(max_act, a / max(nb, 1))
        c_in = cfg.stage_channels[max(i - 1, 0)]
        params += nb * (9 * c_in * ch + 9 * ch * ch) * 4.0
        if i == stage:
            act = a
        if i >= stage:
            break
    opt = params * 2.0  # momentum
    total = 2 * act + params + opt + max_act
    if cache_samples:
        total += cnn_feature_cache_bytes(model, stage, cache_samples,
                                         image_size, cache_dtype)
    return total
