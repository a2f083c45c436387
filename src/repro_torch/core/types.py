"""Shared core types for the PSL global-sampling framework (a numpy copy
of :mod:`repro.core.types`, kept in the port so it imports nothing of
``repro``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClientPopulation:
    """Static description of a federation of K clients.

    Attributes:
      dataset_sizes: (K,) int array, D_k.
      class_counts:  (K, M) int array, per-client class histogram.
      delays:        (K,) float array, straggler delay times omega_k (ms),
                     relative to the fastest client (min is 0).
    """

    dataset_sizes: np.ndarray
    class_counts: np.ndarray
    delays: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "dataset_sizes",
                           np.asarray(self.dataset_sizes, dtype=np.int64))
        object.__setattr__(self, "class_counts",
                           np.asarray(self.class_counts, dtype=np.int64))
        object.__setattr__(self, "delays",
                           np.asarray(self.delays, dtype=np.float64))
        if self.class_counts.ndim != 2:
            raise ValueError("class_counts must be (K, M)")
        if self.dataset_sizes.shape[0] != self.class_counts.shape[0]:
            raise ValueError("K mismatch between dataset_sizes and class_counts")
        if not np.all(self.class_counts.sum(axis=1) == self.dataset_sizes):
            raise ValueError("class_counts rows must sum to dataset_sizes")

    @property
    def num_clients(self) -> int:
        return int(self.dataset_sizes.shape[0])

    @property
    def num_classes(self) -> int:
        return int(self.class_counts.shape[1])

    @property
    def total_size(self) -> int:
        return int(self.dataset_sizes.sum())

    @property
    def class_distributions(self) -> np.ndarray:
        """beta_k, shape (K, M). Rows of all-zero datasets are uniform."""
        d = self.dataset_sizes.astype(np.float64)[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            beta = np.where(d > 0, self.class_counts / np.maximum(d, 1), 0.0)
        return beta

    @property
    def overall_distribution(self) -> np.ndarray:
        """beta_0, shape (M,)."""
        tot = self.class_counts.sum(axis=0).astype(np.float64)
        return tot / max(tot.sum(), 1.0)

    @classmethod
    def homogeneous(cls, num_clients: int, per_client: int, num_classes: int,
                    seed: int = 0) -> "ClientPopulation":
        rng = np.random.default_rng(seed)
        counts = rng.multinomial(per_client,
                                 np.full(num_classes, 1.0 / num_classes),
                                 size=num_clients)
        return cls(dataset_sizes=counts.sum(axis=1), class_counts=counts,
                   delays=np.zeros(num_clients))


@dataclasses.dataclass(frozen=True)
class EpochPlan:
    """Output of a global sampling method for one epoch (dense format).

    Attributes:
      local_batch_sizes: (T, K) int array; B_k^(t). Rows sum to <= B
        (== B except possibly the final ragged step).
      global_batch_size: B.
      method: sampler name that produced the plan.
      em_iterations: total EM iterations spent (LDS only; 0 otherwise).
      pi_history: list of pi vectors used across the epoch (diagnostics).

    The per-step segment accessors (``step_segments``/``step_sizes``) are
    shared with :class:`SparseEpochPlan`, so plan consumers can stream
    either format without branching on the representation.
    """

    local_batch_sizes: np.ndarray
    global_batch_size: int
    method: str
    em_iterations: int = 0
    pi_history: Optional[list] = None

    format = "dense"

    @property
    def num_steps(self) -> int:
        return int(self.local_batch_sizes.shape[0])

    @property
    def num_clients(self) -> int:
        return int(self.local_batch_sizes.shape[1])

    @property
    def plan_nbytes(self) -> int:
        """Bytes held by the plan representation itself."""
        return int(self.local_batch_sizes.nbytes)

    def step_segments(self, t: int) -> tuple:
        """(client_ids, draw_counts) of step t's active clients (ascending
        client id). Zero-count clients never appear in a segment."""
        row = self.local_batch_sizes[t]
        ids = np.flatnonzero(row)
        return ids, row[ids]

    def step_sizes(self, t: int) -> np.ndarray:
        """Dense (K,) row B_·^(t) of step t."""
        return self.local_batch_sizes[t]

    def step_sums(self) -> np.ndarray:
        """(T,) per-step global batch sizes."""
        return self.local_batch_sizes.sum(axis=1)

    def client_totals(self) -> np.ndarray:
        """(K,) per-client draws over the epoch (== D_k for a valid plan)."""
        return self.local_batch_sizes.sum(axis=0)

    def to_dense(self) -> "EpochPlan":
        return self

    def to_sparse(self) -> "SparseEpochPlan":
        """Segment-compress this plan (same values, sparse storage)."""
        builder = SparsePlanBuilder(self.num_clients)
        for t in range(self.num_steps):
            builder.add_step_counts(self.local_batch_sizes[t])
        return builder.build(global_batch_size=self.global_batch_size,
                             method=self.method,
                             em_iterations=self.em_iterations,
                             pi_history=self.pi_history)

    def validate_against(self, pop: ClientPopulation) -> None:
        b = self.local_batch_sizes
        if np.any(b < 0):
            raise AssertionError("negative local batch size")
        if not np.all(b.sum(axis=0) == pop.dataset_sizes):
            raise AssertionError("plan does not deplete every client dataset")
        sums = b.sum(axis=1)
        if not np.all(sums[:-1] == self.global_batch_size):
            raise AssertionError("non-final steps must sum to B")
        if not (0 < sums[-1] <= self.global_batch_size):
            raise AssertionError("final step must be non-empty and <= B")


# Densifying a sparse plan above this many (T, K) entries is almost
# certainly a consumer bug (the dense matrix would dwarf the plan); the
# ``local_batch_sizes`` compatibility property refuses rather than OOM.
DENSIFY_MAX_ENTRIES = 64_000_000


@dataclasses.dataclass(frozen=True)
class SparseEpochPlan:
    """Sparse epoch plan: per-step active-client segments.

    Each global batch touches at most B of the K clients, so the plan is
    stored as T contiguous segments over two flat arrays instead of the
    dense (T, K) matrix — O(T·B + T) memory instead of O(T·K), the
    difference between "proven to K=65536" and million-client planning.

    Attributes:
      step_offsets: (T+1,) int64; step t's segment is the half-open slice
        [step_offsets[t], step_offsets[t+1]) of the two flat arrays.
      client_ids: (nnz,) int32; active client of each segment entry,
        strictly ascending within a step.
      draw_counts: (nnz,) int32; B_k^(t) > 0 for that client.
      num_clients: K (not inferable from the segments).
      global_batch_size / method / em_iterations / pi_history: as in
        :class:`EpochPlan`.
    """

    step_offsets: np.ndarray
    client_ids: np.ndarray
    draw_counts: np.ndarray
    num_clients: int
    global_batch_size: int
    method: str
    em_iterations: int = 0
    pi_history: Optional[list] = None

    format = "sparse"

    def __post_init__(self):
        object.__setattr__(self, "step_offsets",
                           np.asarray(self.step_offsets, dtype=np.int64))
        object.__setattr__(self, "client_ids",
                           np.asarray(self.client_ids, dtype=np.int32))
        object.__setattr__(self, "draw_counts",
                           np.asarray(self.draw_counts, dtype=np.int32))

    @property
    def num_steps(self) -> int:
        return int(self.step_offsets.shape[0] - 1)

    @property
    def nnz(self) -> int:
        return int(self.client_ids.shape[0])

    @property
    def plan_nbytes(self) -> int:
        """Bytes held by the plan representation itself."""
        return int(self.step_offsets.nbytes + self.client_ids.nbytes
                   + self.draw_counts.nbytes)

    @property
    def local_batch_sizes(self) -> np.ndarray:
        """Dense (T, K) compatibility view (small plans only).

        Legacy consumers that index the full matrix keep working at small
        scale; above ``DENSIFY_MAX_ENTRIES`` this raises instead of
        materializing gigabytes — stream ``step_segments``/``step_sizes``.
        """
        if self.num_steps * self.num_clients > DENSIFY_MAX_ENTRIES:
            raise ValueError(
                f"refusing to densify a ({self.num_steps}, "
                f"{self.num_clients}) sparse plan "
                f"(> {DENSIFY_MAX_ENTRIES} entries); iterate "
                f"step_segments()/step_sizes() instead")
        return self._dense_matrix()

    def _dense_matrix(self) -> np.ndarray:
        dense = np.zeros((self.num_steps, self.num_clients), dtype=np.int64)
        step_of = np.repeat(np.arange(self.num_steps),
                            np.diff(self.step_offsets))
        dense[step_of, self.client_ids] = self.draw_counts
        return dense

    def step_segments(self, t: int) -> tuple:
        lo, hi = int(self.step_offsets[t]), int(self.step_offsets[t + 1])
        return self.client_ids[lo:hi], self.draw_counts[lo:hi]

    def step_sizes(self, t: int) -> np.ndarray:
        row = np.zeros(self.num_clients, dtype=np.int64)
        ids, cnts = self.step_segments(t)
        row[ids] = cnts
        return row

    def step_sums(self) -> np.ndarray:
        cum = np.concatenate([[0], np.cumsum(self.draw_counts,
                                             dtype=np.int64)])
        return cum[self.step_offsets[1:]] - cum[self.step_offsets[:-1]]

    def client_totals(self) -> np.ndarray:
        return np.bincount(self.client_ids,
                           weights=self.draw_counts,
                           minlength=self.num_clients).astype(np.int64)

    def to_dense(self) -> EpochPlan:
        """Materialize the dense (T, K) plan (small plans / tests)."""
        return EpochPlan(local_batch_sizes=self.local_batch_sizes,
                         global_batch_size=self.global_batch_size,
                         method=self.method,
                         em_iterations=self.em_iterations,
                         pi_history=self.pi_history)

    def to_sparse(self) -> "SparseEpochPlan":
        return self

    def validate_against(self, pop: ClientPopulation) -> None:
        """Streaming twin of EpochPlan.validate_against — never densifies."""
        if np.any(self.draw_counts <= 0):
            raise AssertionError("sparse segments must hold positive counts")
        if (np.any(self.client_ids < 0)
                or np.any(self.client_ids >= self.num_clients)):
            raise AssertionError("segment client id out of range")
        within = np.ones(self.nnz, dtype=bool)
        starts = self.step_offsets[:-1]
        interior = np.setdiff1d(np.arange(self.nnz), starts,
                                assume_unique=False)
        within[interior] = (self.client_ids[interior]
                            > self.client_ids[interior - 1])
        if not within.all():
            raise AssertionError("segment client ids must ascend per step")
        if not np.array_equal(self.client_totals(), pop.dataset_sizes):
            raise AssertionError("plan does not deplete every client dataset")
        sums = self.step_sums()
        if not np.all(sums[:-1] == self.global_batch_size):
            raise AssertionError("non-final steps must sum to B")
        if not (0 < sums[-1] <= self.global_batch_size):
            raise AssertionError("final step must be non-empty and <= B")


class SparsePlanBuilder:
    """Accumulates per-step segments into a :class:`SparseEpochPlan`.

    The NumPy samplers feed it one dense (K,) counts row per step (the row
    is compressed and dropped — only O(K) working state is ever live); the
    JAX wrappers feed pre-compressed (ids, counts) segments.
    """

    def __init__(self, num_clients: int):
        self.num_clients = int(num_clients)
        self._ids: list = []
        self._cnts: list = []
        self._lens: list = []

    def add_step_counts(self, counts: np.ndarray) -> None:
        counts = np.asarray(counts)
        ids = np.flatnonzero(counts)
        self.add_step_segments(ids, counts[ids])

    def add_step_segments(self, ids: np.ndarray, counts: np.ndarray) -> None:
        self._ids.append(np.asarray(ids, dtype=np.int32))
        self._cnts.append(np.asarray(counts, dtype=np.int32))
        self._lens.append(len(self._ids[-1]))

    def build(self, global_batch_size: int, method: str,
              em_iterations: int = 0,
              pi_history: Optional[list] = None) -> SparseEpochPlan:
        offsets = np.concatenate(
            [[0], np.cumsum(np.asarray(self._lens, dtype=np.int64))])
        ids = (np.concatenate(self._ids) if self._ids
               else np.zeros(0, np.int32))
        cnts = (np.concatenate(self._cnts) if self._cnts
                else np.zeros(0, np.int32))
        return SparseEpochPlan(step_offsets=offsets, client_ids=ids,
                               draw_counts=cnts,
                               num_clients=self.num_clients,
                               global_batch_size=global_batch_size,
                               method=method, em_iterations=em_iterations,
                               pi_history=pi_history)
