"""Non-IID data partitioning across clients (numpy copy of
:mod:`repro.core.partition`: the same labels and seed give the same
partition, bit for bit).

Implements the paper's split strategies (Sec. V-A):
  * IID: uniform random assignment.
  * Extended-Dirichlet: each client holds exactly C classes with strongly
    varying dataset sizes (the paper uses C=2 on CIFAR10), following the
    extended Dirichlet strategy of Li & Lyu [15].
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from repro_torch.core.types import ClientPopulation


def _population_from_assignment(labels: np.ndarray, num_classes: int,
                                client_indices: List[np.ndarray]
                                ) -> ClientPopulation:
    k = len(client_indices)
    counts = np.zeros((k, num_classes), dtype=np.int64)
    for ki, idx in enumerate(client_indices):
        if idx.size:
            counts[ki] = np.bincount(labels[idx], minlength=num_classes)
    return ClientPopulation(dataset_sizes=counts.sum(axis=1),
                            class_counts=counts,
                            delays=np.zeros(k))


def partition_iid(labels: np.ndarray, num_clients: int, num_classes: int,
                  seed: int = 0) -> Tuple[List[np.ndarray], ClientPopulation]:
    rng = np.random.default_rng(seed)
    perm = rng.permutation(labels.shape[0])
    parts = np.array_split(perm, num_clients)
    parts = [np.sort(p) for p in parts]
    return parts, _population_from_assignment(labels, num_classes, parts)


def partition_dirichlet(labels: np.ndarray, num_clients: int,
                        num_classes: int, classes_per_client: int = 2,
                        concentration: float = 0.3, seed: int = 0
                        ) -> Tuple[List[np.ndarray], ClientPopulation]:
    """Extended-Dirichlet split: exactly `classes_per_client` classes each.

    Class→client assignment is round-robin over a shuffled client list so each
    class is held by roughly K*C/M clients; within a class, the per-holder
    shares are Dirichlet(concentration) — small concentration gives the
    "strongly varying dataset sizes" of the paper's Fig. 4.
    """
    rng = np.random.default_rng(seed)
    # Assign each client `classes_per_client` classes, covering all classes.
    class_holders: List[List[int]] = [[] for _ in range(num_classes)]
    slots = []
    for _ in range(classes_per_client):
        order = rng.permutation(num_clients)
        slots.extend(order.tolist())
    # Deal classes to slots round-robin so every class gets ~equal holders.
    for i, client in enumerate(slots):
        class_holders[i % num_classes].append(client)
    # Guard: a class with no holder steals a random client.
    for m in range(num_classes):
        if not class_holders[m]:
            class_holders[m].append(int(rng.integers(num_clients)))

    client_indices: List[List[int]] = [[] for _ in range(num_clients)]
    for m in range(num_classes):
        idx_m = np.flatnonzero(labels == m)
        rng.shuffle(idx_m)
        holders = class_holders[m]
        shares = rng.dirichlet(np.full(len(holders), concentration))
        # Convert shares to integer split points.
        counts = np.floor(shares * idx_m.size).astype(np.int64)
        counts[-1] = idx_m.size - counts[:-1].sum()
        start = 0
        for holder, c in zip(holders, counts):
            client_indices[holder].extend(idx_m[start:start + c].tolist())
            start += c

    # Every client must own at least one sample: steal from the richest.
    sizes = np.array([len(ci) for ci in client_indices])
    for ki in np.flatnonzero(sizes == 0):
        donor = int(np.argmax([len(ci) for ci in client_indices]))
        client_indices[ki].append(client_indices[donor].pop())

    parts = [np.sort(np.asarray(ci, dtype=np.int64)) for ci in client_indices]
    return parts, _population_from_assignment(labels, num_classes, parts)
