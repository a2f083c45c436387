"""Federated client stores, the plan-driven global-batch iterator and the
LM federation (numpy copy of :mod:`repro.data.federated`: the same plan
and seed give the same batches, bit for bit, dense or sparse).

The server never touches client features; it only knows dataset sizes and
class counts (the paper's availability assumption). The iterator
materializes the global batches of an epoch plan: for step t it asks each
client with B_k^t > 0 for that many locally-uniform-without-replacement
samples and fills the static (B, ...) buffer together with client-id tags
and the slot-weight vector implementing the chosen gradient aggregation.
Batch assembly is one fancy-index gather a step over a client-major flat
copy of the shards, through one (D,) index permutation an epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.psl import slot_weights_segments
from repro_torch.core.types import ClientPopulation, EpochPlan


@dataclasses.dataclass
class ClientStore:
    """Per-client data shards + sampling state."""
    features: List[np.ndarray]          # K arrays (D_k, ...)
    labels: List[np.ndarray]            # K arrays (D_k,)
    population: ClientPopulation

    @classmethod
    def from_partition(cls, features: np.ndarray, labels: np.ndarray,
                       parts: List[np.ndarray], population: ClientPopulation
                       ) -> "ClientStore":
        # one flat client-major copy; per-client shards are views into it,
        # so the vectorized iterator's flat_arrays() costs no second copy
        lengths = np.array([len(p) for p in parts], dtype=np.int64)
        base = np.cumsum(lengths) - lengths
        flat_f = features[np.concatenate(parts)] if parts else \
            np.zeros((0,) + features.shape[1:], features.dtype)
        flat_l = labels[np.concatenate(parts)] if parts else \
            np.zeros((0,), labels.dtype)
        store = cls(features=[flat_f[b:b + n] for b, n in zip(base, lengths)],
                    labels=[flat_l[b:b + n] for b, n in zip(base, lengths)],
                    population=population)
        object.__setattr__(store, "_flat_cache", (flat_f, flat_l, base))
        return store

    @classmethod
    def from_flat(cls, flat_features: np.ndarray, flat_labels: np.ndarray,
                  base: np.ndarray, population: ClientPopulation
                  ) -> "ClientStore":
        """Build a store directly from client-major flat arrays.

        The million-client path: a list of K per-client views costs O(K)
        Python objects (≈ GBs at K = 1e6), but the vectorized iterator only
        ever reads ``flat_arrays()`` — so this constructor skips the view
        list entirely. ``base[k]`` is client k's start offset into the flat
        arrays.
        """
        store = cls(features=[], labels=[], population=population)
        base = np.asarray(base, dtype=np.int64)
        object.__setattr__(store, "_flat_cache",
                           (flat_features, flat_labels, base))
        object.__setattr__(store, "_num_clients_flat", int(base.shape[0]))
        return store

    @property
    def num_clients(self) -> int:
        n = getattr(self, "_num_clients_flat", None)
        return len(self.features) if n is None else n

    def flat_arrays(self):
        """(flat_features, flat_labels, base) — shards concatenated
        client-major, client k starting at base[k]. Built once and cached;
        iterators permute in index space rather than copying the data."""
        cached = getattr(self, "_flat_cache", None)
        if cached is None:
            if not self.features:
                cached = (np.zeros((0,)), np.zeros((0,), np.int64),
                          np.zeros((0,), np.int64))
            else:
                lengths = np.array([len(f) for f in self.features],
                                   dtype=np.int64)
                cached = (np.concatenate(self.features),
                          np.concatenate(self.labels),
                          np.cumsum(lengths) - lengths)
            object.__setattr__(self, "_flat_cache", cached)
        return cached


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


def _run_offsets(sizes: np.ndarray) -> np.ndarray:
    """Within-run offsets [0..n_0), [0..n_1), ... for `repeat`-built gathers."""
    total = int(sizes.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.repeat(np.cumsum(sizes) - sizes, sizes)
    return np.arange(total, dtype=np.int64) - starts


class GlobalBatchIterator:
    """Iterates the global batches of one epoch plan.

    Equivalent to asking client k for its next B_k^t locally-shuffled
    samples at each step; implemented as vectorized gathers against a flat
    permuted copy of the shards. Accepts a dense :class:`EpochPlan` or a
    :class:`repro_torch.core.types.SparseEpochPlan` interchangeably — batch
    assembly streams per-step ``step_segments`` either way, and for a given
    (plan, seed) the emitted batches are bit-identical across formats.

    ``num_shards`` opts into the mesh-parallel slot layout: each batch's
    rows are stably reordered by the contributing client's home data shard
    (client k → shard k mod S, the static map of
    ``repro_torch.launch.distributed``) and a per-slot ``"shard"`` tag is
    emitted (-1 for padding). Reordering slots never changes the training
    step: the loss is a weighted sum over slots and padding carries
    weight 0.
    """

    def __init__(self, store: ClientStore, plan: EpochPlan,
                 aggregation: str = "global_mean", seed: int = 0,
                 pad_to: Optional[int] = None,
                 num_shards: Optional[int] = None):
        self.store = store
        self.plan = plan
        self.aggregation = aggregation
        self.pad_to = pad_to or plan.global_batch_size
        rng = np.random.default_rng(seed)
        # per-client random visit order = uniform sampling w/o replacement,
        # composed into one (D,) index map over the store's cached flat
        # arrays — the per-epoch state is an integer permutation, not a
        # copy of the data. One lexsort by (client, random key) permutes
        # every client's segment at once: no O(K) Python loop.
        self._flat_features, self._flat_labels, self._base = \
            store.flat_arrays()
        d_total = self._flat_labels.shape[0]
        lengths = np.diff(np.append(self._base, d_total))
        cids = np.repeat(np.arange(store.num_clients, dtype=np.int64),
                         lengths)
        self._perm = np.lexsort((rng.random(d_total), cids))
        self._client_ids = np.arange(store.num_clients, dtype=np.int64)
        self.num_shards = num_shards
        self._shard_of_client = (
            self._client_ids % num_shards if num_shards else None)
        self._consumed = False

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # single-use per epoch: a silent second pass would replay the exact
        # same batches (same permutation), masking double-consume bugs
        if self._consumed:
            raise RuntimeError(
                "GlobalBatchIterator is single-use; construct a new one "
                "(with a fresh seed) for another epoch")
        self._consumed = True
        cursor = np.zeros(self.store.num_clients, dtype=np.int64)
        for t in range(self.plan.num_steps):
            # Stream the step's active-client segment (ids ascending, so a
            # dense plan's repeat-over-all-K order is reproduced exactly).
            # Per-step work is O(B), independent of K — with a sparse plan
            # no (K,) row is ever materialized.
            ids, cnts = self.plan.step_segments(t)
            ids = np.asarray(ids, dtype=np.int64)
            cnts = np.asarray(cnts, dtype=np.int64)
            idx = self._perm[np.repeat(self._base[ids] + cursor[ids], cnts)
                             + _run_offsets(cnts)]
            cursor[ids] += cnts
            cids = np.repeat(ids, cnts)
            slot_cnts = np.repeat(cnts, cnts)   # owner's B_k^t per slot
            if self._shard_of_client is not None and len(cids):
                # group the step's slots by home shard (stable: preserves
                # the per-client draw order within each shard segment)
                order = np.argsort(self._shard_of_client[cids],
                                   kind="stable")
                idx, cids, slot_cnts = idx[order], cids[order], \
                    slot_cnts[order]
            feats = self._flat_features[idx]
            labs = self._flat_labels[idx]
            b = self.pad_to
            if feats.shape[0] < b:     # final ragged step → pad + mask
                pad = b - feats.shape[0]
                feats = np.concatenate(
                    [feats, np.zeros((pad,) + feats.shape[1:],
                                     feats.dtype)])
                labs = np.concatenate([labs, np.zeros(pad, labs.dtype)])
                cids = np.concatenate([cids, np.full(pad, -1)])
                slot_cnts = np.concatenate([slot_cnts,
                                            np.ones(pad, np.int64)])
            w = slot_weights_segments(cids, slot_cnts,
                                      self.store.population.dataset_sizes,
                                      self.aggregation)
            out = {"features": feats, "labels": labs.astype(np.int64),
                   "client_ids": cids, "weights": w, "step": t}
            if self._shard_of_client is not None:
                out["shard"] = np.where(
                    cids >= 0, self._shard_of_client[np.maximum(cids, 0)],
                    -1)
            yield out
