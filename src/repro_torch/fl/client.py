"""Simulated FL clients with heterogeneous memory / compute (paper §V-A;
counterpart of ``repro/fl/client.py``, numpy host state as there).

Each client owns a private shard of the dataset, a memory capacity drawn
from the paper's two contention scenarios, and a runtime capability c_i.
Shards stay numpy on the host; the round engine moves each round's
minibatches to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.selector.selection import ClientInfo
from repro_torch.core.selector.vectorized import ClientPopulation
from repro_torch.models.module import tree_leaves

# Paper memory scenarios: available RAM (GiB) under high / low contention
HIGH_CONTENTION_GB = (0.5, 0.75, 1.0, 1.5, 2.0)
LOW_CONTENTION_GB = (2.0, 3.0, 4.0, 6.0, 8.0)
# Heterogeneous device tiers (relative FLOP/s; RPi ... Jetson TX2 ... phone)
CAPABILITY_TIERS = (0.3e9, 1.0e9, 2.5e9, 5.0e9, 10.0e9)


def batch_index_plan(n: int, batch_size: int, epochs: int, seed: int
                     ) -> List[np.ndarray]:
    """The exact minibatch index sequence a client runs locally: per-epoch
    permutation, drop-last."""
    rng = np.random.RandomState(seed)
    plan = []
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch_size + 1, batch_size):
            plan.append(order[i:i + batch_size])
    return plan


@dataclass
class SimClient:
    client_id: int
    data: Dict[str, np.ndarray]
    memory_bytes: float
    capability: float
    seed: int = 0
    link_rate: float = float("inf")   # uplink bytes/s (inf = free network)

    @property
    def num_samples(self) -> int:
        return len(self.data["y"]) if "y" in self.data else len(self.data["labels"])

    def round_seed(self, round_idx: int) -> int:
        return self.seed * 99991 + round_idx

    def batches(self, batch_size: int, epochs: int, seed: int):
        for idx in batch_index_plan(self.num_samples, batch_size, epochs,
                                    seed):
            yield {k: v[idx] for k, v in self.data.items()}

    def local_train(self, step_fn: Callable, active, frozen, bn_state,
                    opt_state, *, batch_size: int, epochs: int,
                    round_idx: int):
        """Runs a stage step (``core/freezing_cnn.make_cnn_stage_step``)
        over the local minibatches, each moved to the device of ``active``.

        Returns (active, bn_state, mean_loss, num_batches)."""
        dev = next(iter(tree_leaves(active))).device
        losses = []
        for batch in self.batches(batch_size, epochs,
                                  self.round_seed(round_idx)):
            tb = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
            active, bn_state, opt_state, loss = step_fn(
                active, frozen, bn_state, opt_state, tb)
            losses.append(float(loss))
        mean_loss = float(np.mean(losses)) if losses else 0.0
        return active, bn_state, mean_loss, len(losses)

    def info(self) -> ClientInfo:
        return ClientInfo(self.client_id, self.memory_bytes, self.capability,
                          self.num_samples)

    def label_histogram(self, num_classes: int) -> np.ndarray:
        y = self.data["y"] if "y" in self.data else self.data["labels"]
        return np.bincount(np.asarray(y).ravel(), minlength=num_classes)


def fleet_label_histograms(clients: List[SimClient], num_classes: int
                           ) -> np.ndarray:
    """[N, num_classes] label histograms in ascending-client-id order."""
    return np.stack([c.label_histogram(num_classes)
                     for c in sorted(clients, key=lambda c: c.client_id)])


def fleet_population(clients: List[SimClient], *, community_id=None,
                     n_communities: int = 1, device="cuda"):
    """Snapshot a simulated fleet into a ``ClientPopulation``
    (structure-of-arrays on ``device``) for the vectorized selector, in
    ascending-client-id order."""
    return ClientPopulation.from_infos(
        [c.info() for c in sorted(clients, key=lambda c: c.client_id)],
        community_id=community_id, n_communities=n_communities,
        device=device)


def make_client_fleet(data: Dict[str, np.ndarray], parts: List[np.ndarray], *,
                      scenario: str = "low", seed: int = 0,
                      link_rate_pool: Optional[List[float]] = None
                      ) -> List[SimClient]:
    """Build a heterogeneous fleet from a dataset + index partition.
    ``link_rate_pool``: optional uplink rates (bytes/s) drawn per client."""
    rng = np.random.RandomState(seed)
    mem_pool = HIGH_CONTENTION_GB if scenario == "high" else LOW_CONTENTION_GB
    clients = []
    for cid, idx in enumerate(parts):
        local = {k: v[idx] for k, v in data.items()}
        clients.append(SimClient(
            client_id=cid, data=local,
            memory_bytes=float(rng.choice(mem_pool)) * 2**30,
            capability=float(rng.choice(CAPABILITY_TIERS)),
            seed=seed + cid,
            link_rate=(float(rng.choice(link_rate_pool))
                       if link_rate_pool else float("inf"))))
    return clients
