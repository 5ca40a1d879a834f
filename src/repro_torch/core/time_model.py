"""Stage-based system time model — Eqs. (5)-(7) (counterpart of the parts
of ``repro/core/time_model.py`` that the CNN sync path uses; numpy).

t_t^i = rho * FLOPs_t * |D_i| / c_i          (Eq. 6)
T_r(S, t) = max_{i in S} t_t^i              (Eq. 7, synchronous round)

These are virtual seconds of the simulated fleet, not time on the card.
The array forms compute in float32, as the reference's jitted forms do.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def cnn_cached_compute_scale(stage: int) -> float:
    """Fraction of a stage-``stage`` CNN local step left when the frozen
    prefix is served from the feature cache: a recompute step costs about
    ``stage`` prefix-forward units plus ~3 units of active fwd+bwd, a cached
    step just the 3 — scale 3 / (stage + 3). Stage 0 has no prefix."""
    return 3.0 / (max(stage, 0) + 3.0)


def stage_times(flops_per_sample, num_samples, capability, rho=1.0
                ) -> np.ndarray:
    """Eq. (6) over client arrays: [N] f32 seconds of local compute."""
    return (np.float32(rho) * np.float32(flops_per_sample)
            * np.asarray(num_samples, np.float32)
            / np.maximum(np.asarray(capability, np.float32), np.float32(1e-9)))


def uplink_times(payload_bytes, link_rate) -> np.ndarray:
    """[N] f32 seconds to put ``payload_bytes`` on each client's uplink;
    infinite link rates (the free-network default) cost 0."""
    rate = np.asarray(link_rate, np.float32)
    with np.errstate(divide="ignore"):
        t = np.float32(payload_bytes) / np.maximum(rate, np.float32(1e-9))
    return np.where(np.isinf(rate), np.float32(0.0), t).astype(np.float32)


def completion_jitter(n: int, seed: int, round_idx: int,
                      sigma: float) -> np.ndarray:
    """[n] multiplicative lognormal jitter, deterministic per (seed, round)."""
    if sigma <= 0.0:
        return np.ones(n, np.float32)
    rng = np.random.RandomState((seed * 1_000_003 + round_idx) % (2 ** 32))
    return np.exp(rng.randn(n).astype(np.float32) * sigma
                  - 0.5 * sigma * sigma)


def completion_times(compute_s, uplink_s, jitter) -> np.ndarray:
    """Per-client round completion time: jittered compute + uplink."""
    return (np.asarray(compute_s, np.float32) * jitter
            + np.asarray(uplink_s, np.float32))


def cohort_round_time(times: Sequence[float]) -> float:
    """Eq. (7) over precomputed completion times; empty cohort -> 0.0."""
    times = np.asarray(list(times), np.float64)
    if times.size == 0:
        return 0.0
    return float(times.max())
