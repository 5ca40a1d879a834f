"""Stage-based system time model — Eqs. (5)-(7) (counterpart of
``repro/core/time_model.py``).

t_t^i = rho * FLOPs_t * |D_i| / c_i          (Eq. 6)
T_r(S, t) = max_{i in S} t_t^i              (Eq. 7, synchronous round)

These are virtual seconds of the simulated fleet, not time on the card.
``client_stage_time``, ``round_time``, ``stage_speedup`` and
``lm_cached_compute_scale`` are the LM forms over the memory model's Eq. 5
FLOPs, in Python floats as the reference's.
The ``*_vec`` forms compute in float32 on their inputs' device, as the
reference's jitted forms do (``completion_times_vec`` rounds its product
and sum once, as XLA contracts them); ``stage_times``, ``uplink_times``
and ``completion_times`` are the same bodies on host numpy arrays, which
``fl/sim.py:FleetTimeModel`` uses.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.core.memory_model import (full_model_flops,
                                           layer_fwd_flops_per_token,
                                           stage_flops)


def client_stage_time(cfg, stage: int, num_samples: int,
                      capability_flops: float, *, batch: int = 1,
                      seq: int = 1, rho: float = 1.0) -> float:
    """Eq. (6): seconds for a client to finish stage-t local training."""
    per_sample = stage_flops(cfg, stage, batch, seq)["total"] / max(batch, 1)
    return rho * per_sample * num_samples / capability_flops


def round_time(cfg, stage: int, clients: Sequence[Dict], *,
               batch: int = 1, seq: int = 1, rho: float = 1.0) -> float:
    """Eq. (7): a synchronous round lasts as long as its slowest client
    ({"num_samples", "capability"} each); an empty cohort costs 0.0."""
    clients = list(clients)
    if not clients:
        return 0.0
    return max(client_stage_time(cfg, stage, c["num_samples"],
                                 c["capability"], batch=batch, seq=seq,
                                 rho=rho)
               for c in clients)


def stage_speedup(cfg, stage: int, *, batch: int = 1, seq: int = 128
                  ) -> float:
    """FLOPs speedup of stage-t training over full-model training."""
    full = full_model_flops(cfg, batch, seq)
    return full / stage_flops(cfg, stage, batch, seq)["total"]


def lm_cached_compute_scale(cfg, stage: int, *, batch: int = 1,
                            seq: int = 128) -> float:
    """The LM twin of ``cnn_cached_compute_scale``, exact under Eq. 5: the
    share of a stage's FLOPs left when the frozen prefix's forward is read
    from the feature cache."""
    fl = stage_flops(cfg, stage, batch, seq)
    lo = cfg.block_boundaries()[stage]
    kinds = cfg.layer_kinds()
    tok = batch * seq
    fwd_frozen = sum(layer_fwd_flops_per_token(cfg, kinds[i], seq)
                     for i in range(lo)) * tok
    return max(fl["total"] - fwd_frozen, 0.0) / fl["total"]


def cnn_cached_compute_scale(stage: int) -> float:
    """Fraction of a stage-``stage`` CNN local step left when the frozen
    prefix is served from the feature cache: a recompute step costs about
    ``stage`` prefix-forward units plus ~3 units of active fwd+bwd, a cached
    step just the 3 — scale 3 / (stage + 3). Stage 0 has no prefix."""
    return 3.0 / (max(stage, 0) + 3.0)


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA contracts it on the
    CPU. The f32 product is exact in f64, so the f64 sum rounds once and
    the cast a second time; the two roundings part from one only when the
    f64 sum lands on an f32 rounding midpoint."""
    return (a.double() * b.double() + c.double()).float()


def stage_times_vec(flops_per_sample, num_samples, capability, rho=1.0
                    ) -> torch.Tensor:
    """Eq. (6) over client tensors: [N] f32 seconds of local compute, on
    ``num_samples``' device. ``flops_per_sample`` may be a scalar (one
    stage for the whole fleet) or an [N] array (per-client sub-models)."""
    ns = torch.as_tensor(num_samples)
    dev = ns.device
    return (_f32(rho, dev) * _f32(flops_per_sample, dev)
            * ns.to(torch.float32) / torch.clamp_min(_f32(capability, dev),
                                                     1e-9))


def uplink_times_vec(payload_bytes, link_rate) -> torch.Tensor:
    """[N] f32 seconds to put ``payload_bytes`` on each client's uplink,
    on ``link_rate``'s device; infinite link rates (the free-network
    default) cost 0."""
    rate = torch.as_tensor(link_rate).to(torch.float32)
    t = _f32(payload_bytes, rate.device) / torch.clamp_min(rate, 1e-9)
    return torch.where(torch.isinf(rate), torch.zeros_like(t), t)


def completion_times_vec(compute_s, uplink_s, jitter) -> torch.Tensor:
    """Per-client round completion time: jittered compute + uplink, the
    product and the sum rounded once (the reference's contracted form)."""
    c = torch.as_tensor(compute_s).to(torch.float32)
    return fma32(c, _f32(jitter, c.device), _f32(uplink_s, c.device))


def stage_times(flops_per_sample, num_samples, capability, rho=1.0
                ) -> np.ndarray:
    """``stage_times_vec`` on host arrays: [N] f32 numpy seconds."""
    return stage_times_vec(flops_per_sample, np.asarray(num_samples),
                           capability, rho).numpy()


def uplink_times(payload_bytes, link_rate) -> np.ndarray:
    """``uplink_times_vec`` on host arrays: [N] f32 numpy seconds."""
    return uplink_times_vec(payload_bytes, np.asarray(link_rate)).numpy()


def completion_jitter(n: int, seed: int, round_idx: int,
                      sigma: float) -> np.ndarray:
    """[n] multiplicative lognormal jitter, deterministic per (seed, round)."""
    if sigma <= 0.0:
        return np.ones(n, np.float32)
    rng = np.random.RandomState((seed * 1_000_003 + round_idx) % (2 ** 32))
    return np.exp(rng.randn(n).astype(np.float32) * sigma
                  - 0.5 * sigma * sigma)


def completion_times(compute_s, uplink_s, jitter) -> np.ndarray:
    """``completion_times_vec`` on host arrays: [N] f32 numpy seconds."""
    return completion_times_vec(np.asarray(compute_s, np.float32),
                                np.asarray(uplink_s, np.float32),
                                np.asarray(jitter, np.float32)).numpy()


def cohort_round_time(times: Sequence[float]) -> float:
    """Eq. (7) over precomputed completion times; empty cohort -> 0.0."""
    times = np.asarray(list(times), np.float64)
    if times.size == 0:
        return 0.0
    return float(times.max())
