"""The LM federation (port of :func:`repro.data.federated.
build_lm_client_store`, numpy, same seed -> same client shards).

``ClientStore`` and ``GlobalBatchIterator`` (the classification path) are
not ported yet; they come with the CNN training slice (ROADMAP A.3).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.types import ClientPopulation


def build_lm_client_store(vocab_size: int, num_clients: int, sequences: int,
                          seq_len: int, seed: int = 0):
    """Non-IID LM federation: clients get style-skewed sequence sets.

    Returns ``(data, pop)`` — per-client token arrays of shape
    (D_k, seq_len + 1) and the matching :class:`ClientPopulation` whose
    "classes" are sequence styles.
    """
    from repro_torch.data.synthetic import make_lm_dataset
    toks, styles = make_lm_dataset(sequences, seq_len + 1, vocab_size,
                                   num_styles=max(2, num_clients // 2),
                                   seed=seed)
    # each client holds 1-2 styles (non-IID over sequence styles)
    order = np.argsort(styles, kind="stable")
    parts = np.array_split(order, num_clients)
    class_counts = np.zeros((num_clients, styles.max() + 1), np.int64)
    for k, p in enumerate(parts):
        class_counts[k] = np.bincount(styles[p], minlength=styles.max() + 1)
    pop = ClientPopulation(dataset_sizes=np.array([len(p) for p in parts]),
                           class_counts=class_counts,
                           delays=np.zeros(num_clients))
    data = [toks[p] for p in parts]
    return data, pop
