"""Deterministic fault injection for federated rounds (counterpart of
``repro/fl/faults.py``).

``FaultInjector`` draws one fault decision per (seed, round, client) with
the splitmix64 hash of ``hash_draws``, bit for bit the reference's: a
client's draw does not depend on the order of the cohort or on which other
clients are queried, so a schedule is the same for any subset.

Fault kinds:

  ``"nan"`` / ``"inf"``   the client's update delta is non-finite, and its
                          reported loss goes NaN
  ``"signflip"``          the delta is negated: norm-preserving, so only a
                          robust aggregator (``"trimmed_mean"``,
                          ``"coord_median"``) defends against it
  ``"amplify"``           the delta is scaled by ``amplify`` (50 by
                          default): the median delta-norm screen drops it
  ``"crash"``             compute is spent and the update never reaches the
                          server (the aggregation policies handle it)
  ``"hang"``              an async client never completes; only
                          ``AsyncBufferedAggregation(timeout_s=...)``
                          reclaims its slot

The first four ("corruption" kinds) reach the round engine, which
corrupts the trained update in delta space before screening.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.models.module import tree_map

__all__ = ["FaultInjector", "FAULT_KINDS", "CORRUPT_KINDS", "FAULT_CODE",
           "hash_draws", "corrupt_codes", "apply_fault_to_update"]

#: every kind the injector can draw
FAULT_KINDS: Tuple[str, ...] = ("nan", "inf", "signflip", "amplify",
                                "crash", "hang")
#: kinds that corrupt the content of an update (seen by the engine)
CORRUPT_KINDS: Tuple[str, ...] = ("nan", "inf", "signflip", "amplify")
#: integer codes of the corruption kinds (0 = no fault)
FAULT_CODE: Dict[str, int] = {"nan": 1, "inf": 2, "signflip": 3,
                              "amplify": 4}


def hash_draws(seed: int, round_idx: int, ids: Sequence[int]) -> np.ndarray:
    """One deterministic uniform per (seed, round, client): a splitmix64
    hash of the three, independent of cohort order and of which other
    clients are queried. ``fl/sim.py``'s availability draws use it too."""
    c1 = np.uint64(0x9E3779B97F4A7C15)
    c2 = np.uint64(0xBF58476D1CE4E5B9)
    c3 = np.uint64(0x94D049BB133111EB)
    with np.errstate(over="ignore"):   # uint64 wraparound is the hash
        x = (np.asarray(ids, np.uint64) * c1
             + np.uint64(round_idx % (1 << 63)) * c2
             + np.uint64(seed % (1 << 63)) * c3)
        x ^= x >> np.uint64(30)
        x *= c2
        x ^= x >> np.uint64(27)
        x *= c3
        x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


@dataclass
class FaultInjector:
    """Seeded per-(client, round) fault schedule.

    ``p_fault`` gates whether a client faults this round; a second,
    independent draw picks the kind uniformly from ``kinds``. Faults fire
    only at ``round_idx >= start_round``."""

    p_fault: float = 0.0
    kinds: Tuple[str, ...] = ("nan", "amplify", "crash")
    amplify: float = 50.0
    seed: int = 0
    start_round: int = 0

    def __post_init__(self):
        self.kinds = tuple(self.kinds)
        unknown = [k for k in self.kinds if k not in FAULT_KINDS]
        if unknown:
            raise ValueError(f"unknown fault kinds {unknown}; "
                             f"choose from {FAULT_KINDS}")

    def fault_for(self, cid: int, round_idx: int) -> Optional[str]:
        """This client's fault kind this round (None = healthy)."""
        return self.schedule([cid], round_idx).get(int(cid))

    def schedule(self, ids: Sequence[int], round_idx: int) -> Dict[int, str]:
        """{client_id: kind} for the faulty subset of ``ids`` this round."""
        ids = list(ids)
        if (self.p_fault <= 0.0 or not ids
                or round_idx < self.start_round or not self.kinds):
            return {}
        gate = hash_draws(self.seed + 0x5AFE, round_idx, ids)
        pick = hash_draws(self.seed + 0xFA11, round_idx, ids)
        out: Dict[int, str] = {}
        for cid, g, u in zip(ids, gate, pick):
            if g < self.p_fault:
                out[int(cid)] = self.kinds[
                    min(int(u * len(self.kinds)), len(self.kinds) - 1)]
        return out

    def corrupt_codes(self, faults: Optional[Dict[int, str]],
                      cids: Sequence[int]) -> Optional[np.ndarray]:
        """``corrupt_codes`` of a cohort."""
        return corrupt_codes(faults, cids)


def corrupt_codes(faults: Optional[Dict[int, str]],
                  cids: Sequence[int]) -> Optional[np.ndarray]:
    """{cid: kind} -> [K] int32 codes aligned with ``cids`` (0 = clean);
    None when no client of the cohort carries a corruption kind."""
    if not faults:
        return None
    codes = np.asarray([FAULT_CODE.get(faults.get(int(c), ""), 0)
                        for c in cids], np.int32)
    return codes if codes.any() else None


def apply_fault_to_update(kind: str, params, p_i, *, amplify: float = 50.0):
    """One client's trained params corrupted in delta space, in f32: the
    delta ``p_i - params`` is NaN'd, Inf'd, negated or scaled by
    ``amplify``, then added back to the round's start params."""
    if kind not in CORRUPT_KINDS:
        raise ValueError(f"not a corruption kind: {kind!r}")

    def leaf(p0, pk):
        p0f = p0.float()
        d = pk.float() - p0f
        if kind == "nan":
            d = torch.full_like(d, float("nan"))
        elif kind == "inf":
            d = torch.full_like(d, float("inf"))
        elif kind == "signflip":
            d = -d
        else:  # amplify
            d = d * torch.tensor(amplify, dtype=torch.float32,
                                 device=d.device)
        return (p0f + d).to(pk.dtype)

    with torch.no_grad():
        return tree_map(leaf, params, p_i)
