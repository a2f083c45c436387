"""Global sampling methods for Parallel Split Learning (port of
:mod:`repro.core.sampling`, numpy backend).

The paper's primary contribution: server-side orchestration of the
mini-batch composition. Every sampler consumes a :class:`ClientPopulation`
and emits an :class:`EpochPlan` — the (T, K) matrix of local batch sizes
B_k^(t) that the server ships to the clients before the epoch starts —
or its sparse twin.

The code is ``repro``'s NumPy reference, copied: the same
``np.random.default_rng`` streams draw the same plans, bit for bit, for a
given (method, seed). Samplers:
  * ``fls_plan``  — Fixed Local Sampling (baseline).
  * ``fpls_plan`` — Fixed Proportional Local Sampling (baseline).
  * ``ugs_plan``  — Uniform Global Sampling (Algorithm 1), chunked or
    ``sequential`` draws.

Not ported yet (they raise ``NotImplementedError`` naming the ROADMAP
item): ``lds`` (Latent Dirichlet Sampling needs ``core/em.py`` and
``core/straggler.py``) and ``backend="jax"`` (the vectorized planner
engine, ``core/planner.py``); ``backend="auto"`` resolves to numpy below
``AUTO_BACKEND_MIN_CLIENTS`` clients and raises above it, where
``repro`` would switch to that engine.
"""
from __future__ import annotations


import numpy as np

from repro_torch.core.types import (ClientPopulation, EpochPlan,
                                    SparsePlanBuilder)

_EPS = 1e-12

# Population size from which ``repro``'s ``backend="auto"`` switches to its
# compiled planner engine (``repro.core.planner.AUTO_BACKEND_MIN_CLIENTS``).
AUTO_BACKEND_MIN_CLIENTS = 4096

_PLANNER_ITEM = ("the vectorized planner engine is not ported to "
                 "repro_torch yet (ROADMAP A.8, core/planner.py)")
_LDS_ITEM = ("Latent Dirichlet Sampling is not ported to repro_torch yet "
             "(ROADMAP A.8: core/em.py, straggler.adjust_concentration)")


def resolve_backend(backend: str, num_clients: int) -> str:
    """The port's planner backend: always "numpy". ``"jax"`` raises, and
    ``"auto"`` raises where ``repro`` would pick its compiled engine."""
    backend = backend.lower()
    if backend not in ("numpy", "jax", "auto"):
        raise ValueError(f"unknown planner backend: {backend!r}")
    if backend == "jax" or (backend == "auto"
                            and num_clients >= AUTO_BACKEND_MIN_CLIENTS):
        raise NotImplementedError(
            f"backend={backend!r} with {num_clients} clients: "
            f"{_PLANNER_ITEM}")
    return "numpy"


def _num_steps(total: int, batch: int) -> int:
    return int(np.ceil(total / batch))


# ``plan_format="auto"`` stores the plan sparsely once the dense (T, K)
# matrix would exceed this many entries (128 MiB of int64 rows) — at that
# point the matrix itself, not the drawing, is the planning wall.
AUTO_SPARSE_MIN_DENSE_ENTRIES = 2 ** 24


def resolve_plan_format(plan_format: str, t_steps: int,
                        num_clients: int) -> str:
    """Map "dense" | "sparse" | "auto" to a concrete plan representation.

    The format never changes the draws: a sparse plan is the segment
    compression of the dense plan the same seed would produce
    (tests/test_plan_properties.py pins this bit-identically per backend).
    """
    plan_format = plan_format.lower()
    if plan_format == "auto":
        if t_steps * num_clients > AUTO_SPARSE_MIN_DENSE_ENTRIES:
            return "sparse"
        return "dense"
    if plan_format not in ("dense", "sparse"):
        raise ValueError(f"unknown plan format: {plan_format!r}")
    return plan_format


# ---------------------------------------------------------------------------
# Fixed baselines
# ---------------------------------------------------------------------------

def _fixed_plan(pop: ClientPopulation, per_client: np.ndarray,
                method: str, global_batch_size: int,
                plan_format: str = "dense"):
    """Roll a fixed per-step allocation until all datasets deplete."""
    sizes = pop.dataset_sizes
    # a fixed roll's length is exact up front: client k depletes at step
    # ceil(D_k / B_k'); "auto" resolves against it without rolling twice
    alive = (sizes > 0) & (per_client > 0)
    t_est = int(np.max(np.ceil(sizes[alive] / per_client[alive]))) \
        if alive.any() else 0
    fmt = resolve_plan_format(plan_format, t_est, pop.num_clients)
    remaining = sizes.copy()
    rows = SparsePlanBuilder(pop.num_clients) if fmt == "sparse" else []
    while remaining.sum() > 0:
        take = np.minimum(per_client, remaining)
        if fmt == "sparse":
            rows.add_step_counts(take)
        else:
            rows.append(take)
        remaining = remaining - take
    if fmt == "sparse":
        return rows.build(global_batch_size=global_batch_size, method=method)
    plan = np.stack(rows).astype(np.int64)
    return EpochPlan(local_batch_sizes=plan,
                     global_batch_size=global_batch_size, method=method)


def fls_plan(pop: ClientPopulation, global_batch_size: int,
             plan_format: str = "dense"):
    """Fixed Local Sampling: identical local batch size for every client.

    B' = round(B / K), floored at 1 (paper Sec. V-A rounding rule). The
    *effective* batch size is K * B', i.e. coupled to the client count — the
    failure mode UGS removes.
    """
    k = pop.num_clients
    per = max(1, int(round(global_batch_size / k)))
    per_client = np.full(k, per, dtype=np.int64)
    return _fixed_plan(pop, per_client, "fls", global_batch_size,
                       plan_format=plan_format)


def fpls_plan(pop: ClientPopulation, global_batch_size: int,
              plan_format: str = "dense"):
    """Fixed Proportional Local Sampling: B_k = round(B * D_k / D), min 1."""
    d = pop.dataset_sizes.astype(np.float64)
    raw = global_batch_size * d / max(d.sum(), 1.0)
    per_client = np.maximum(1, np.round(raw)).astype(np.int64)
    return _fixed_plan(pop, per_client, "fpls", global_batch_size,
                       plan_format=plan_format)


# ---------------------------------------------------------------------------
# Uniform Global Sampling (Algorithm 1)
# ---------------------------------------------------------------------------

def _draw_step_counts(rng: np.random.Generator, budget: int,
                      pi: np.ndarray, remaining: np.ndarray
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Draw `budget` slot→client assignments under depletion-aware π.

    Returns (counts for this step, updated π). `remaining` is *not* mutated.
    """
    k = pi.shape[0]
    counts = np.zeros(k, dtype=np.int64)
    rem = remaining.copy()
    need = int(budget)
    pi = pi.copy()
    while need > 0:
        chunk = rng.multinomial(need, pi)
        take = np.minimum(chunk, rem)
        counts += take
        rem -= take
        need -= int(take.sum())
        depleted = (rem == 0) & (pi > 0)
        if depleted.any():
            pi = np.where(rem > 0, pi, 0.0)
            total = pi.sum()
            if total <= _EPS:
                break
            pi = pi / total
    return counts, pi


def ugs_plan(pop: ClientPopulation, global_batch_size: int,
             seed: int = 0,
             sequential: bool = False,
             backend: str = "numpy",
             plan_format: str = "dense"):
    """Uniform Global Sampling (Algorithm 1).

    π_k = D_k / D; each of T=⌈D/B⌉ steps assigns B slots to clients via
    Categorical(π), zeroing and renormalizing π on depletion. Every client's
    dataset is fully consumed over the epoch and each non-final global batch
    has exactly B samples — the effective batch size no longer depends on K.

    ``backend`` is resolved by :func:`resolve_backend` (numpy only in the
    port). ``sequential=True`` forces the literal per-draw reference.

    ``plan_format`` selects the plan representation: "dense" (the (T, K)
    matrix), "sparse" (per-step active-client segments,
    :class:`SparseEpochPlan`), or "auto". The format never changes the
    draws — same seed, same backend ⇒ same per-step batches either way.
    """
    if sequential and backend.lower() == "auto":
        backend = "numpy"       # only the reference implements sequential
    resolve_backend(backend, pop.num_clients)
    rng = np.random.default_rng(seed)
    d = pop.dataset_sizes.astype(np.float64)
    total = int(d.sum())
    b = int(global_batch_size)
    t_steps = _num_steps(total, b)
    fmt = resolve_plan_format(plan_format, t_steps, pop.num_clients)
    plan = SparsePlanBuilder(pop.num_clients) if fmt == "sparse" else \
        np.zeros((t_steps, pop.num_clients), dtype=np.int64)

    remaining = pop.dataset_sizes.copy()
    pi = d / max(d.sum(), _EPS)
    for t in range(t_steps):
        budget = min(b, int(remaining.sum()))
        if sequential:
            counts, pi = _draw_step_counts_sequential(rng, budget, pi,
                                                      remaining)
        else:
            counts, pi = _draw_step_counts(rng, budget, pi, remaining)
        if fmt == "sparse":
            plan.add_step_counts(counts)
        else:
            plan[t] = counts
        remaining -= counts
    if fmt == "sparse":
        return plan.build(global_batch_size=b, method="ugs")
    return EpochPlan(local_batch_sizes=plan, global_batch_size=b,
                     method="ugs")


def _draw_step_counts_sequential(rng: np.random.Generator, budget: int,
                                 pi: np.ndarray, remaining: np.ndarray
                                 ) -> tuple[np.ndarray, np.ndarray]:
    """Literal per-draw transcription of Algorithm 1 (reference/tests)."""
    k = pi.shape[0]
    counts = np.zeros(k, dtype=np.int64)
    rem = remaining.copy()
    pi = pi.copy()
    for _ in range(int(budget)):
        z = rng.choice(k, p=pi)
        counts[z] += 1
        rem[z] -= 1
        if rem[z] == 0:
            pi[z] = 0.0
            total = pi.sum()
            if total <= _EPS:
                break
            pi = pi / total
    return counts, pi


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def make_plan(method: str, pop: ClientPopulation, global_batch_size: int,
              seed: int = 0, backend: str = "numpy",
              plan_format: str = "dense", **kwargs):
    """Uniform entry point used by the data pipeline / trainer.

    ``backend`` selects the planner engine for the stochastic samplers:
    "numpy" (exact reference, default) or "auto" (numpy below
    ``AUTO_BACKEND_MIN_CLIENTS`` clients); "jax" raises. The fixed
    baselines are deterministic rolls and always run on the host.

    ``plan_format`` selects the plan representation: "dense" — the (T, K)
    :class:`EpochPlan` matrix; "sparse" — per-step active-client segments
    (:class:`SparseEpochPlan`, O(T·B) memory since each global batch
    touches at most B of K clients); "auto" — sparse once T·K exceeds
    ``AUTO_SPARSE_MIN_DENSE_ENTRIES``. The format is pure storage: for a
    given (method, backend, seed) the per-step batches are bit-identical
    across formats.
    """
    method = method.lower()
    if method == "ugs":
        return ugs_plan(pop, global_batch_size, seed=seed, backend=backend,
                        plan_format=plan_format)
    if method == "lds":
        raise NotImplementedError(_LDS_ITEM)
    if method == "fpls":
        return fpls_plan(pop, global_batch_size, plan_format=plan_format)
    if method == "fls":
        return fls_plan(pop, global_batch_size, plan_format=plan_format)
    raise ValueError(f"unknown sampling method: {method!r}")
