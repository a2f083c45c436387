"""Global sampling methods for Parallel Split Learning (port of
:mod:`repro.core.sampling`).

The paper's primary contribution: server-side orchestration of the
mini-batch composition. Every sampler consumes a :class:`ClientPopulation`
and emits an :class:`EpochPlan` — the (T, K) matrix of local batch sizes
B_k^(t) that the server ships to the clients before the epoch starts —
or its sparse twin.

Samplers:
  * ``fls_plan``  — Fixed Local Sampling (baseline).
  * ``fpls_plan`` — Fixed Proportional Local Sampling (baseline).
  * ``ugs_plan``  — Uniform Global Sampling (Algorithm 1), chunked or
    ``sequential`` draws.
  * ``lds_plan``  — Latent Dirichlet Sampling (Algorithm 3); Δ=0 reduces to
    UGS up to EM convergence noise.

Backends: this module holds ``repro``'s NumPy *reference* implementation,
copied: the same ``np.random.default_rng`` streams draw the same plans,
bit for bit, for a given (method, seed). ``ugs_plan``/``lds_plan``/
``make_plan`` accept ``backend="numpy" | "jax" | "auto"`` as ``repro``'s
do, so its specs load unchanged; in the port ``"jax"`` names the
vectorized engine of :mod:`repro_torch.core.planner`, which runs in torch
on the card, and ``"auto"`` picks it from ``AUTO_BACKEND_MIN_CLIENTS``
clients on (:func:`repro_torch.core.planner.resolve_backend`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import em as em_lib
from repro_torch.core import straggler as straggler_lib
from repro_torch.core.types import (ClientPopulation, EpochPlan,
                                    SparsePlanBuilder)

_EPS = 1e-12


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
             plan_format: str = "dense",
             device="cuda"):
    """Uniform Global Sampling (Algorithm 1).

    π_k = D_k / D; each of T=⌈D/B⌉ steps assigns B slots to clients via
    Categorical(π), zeroing and renormalizing π on depletion. Every client's
    dataset is fully consumed over the epoch and each non-final global batch
    has exactly B samples — the effective batch size no longer depends on K.

    ``backend="jax"`` routes to the vectorized torch engine in
    :mod:`repro_torch.core.planner` on ``device`` (same count
    distribution, different PRNG); ``"auto"`` picks it for large K. The
    numpy backend is the host reference and ignores ``device``.
    ``sequential=True`` forces the literal per-draw NumPy reference and is
    incompatible with the vectorized engine.

    ``plan_format`` selects the plan representation: "dense" (the (T, K)
    matrix), "sparse" (per-step active-client segments,
    :class:`SparseEpochPlan`), or "auto". The format never changes the
    draws — same seed, same backend ⇒ same per-step batches either way.
    """
    from repro_torch.core import planner as planner_lib
    if sequential and backend.lower() == "auto":
        backend = "numpy"       # only the reference implements sequential
    if planner_lib.resolve_backend(backend, pop.num_clients) == "jax":
        if sequential:
            raise ValueError("sequential reference draws are numpy-only")
        return planner_lib.ugs_plan_torch(pop, global_batch_size, seed=seed,
                                          plan_format=plan_format,
                                          device=device)
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
# Latent Dirichlet Sampling (Algorithm 3)
# ---------------------------------------------------------------------------

def initialize_concentration(pop: ClientPopulation, delta: float,
                             sample_size: Optional[int] = None) -> np.ndarray:
    """Two-stage α initialization (Sec. IV-D).

    α_k = (D_k / D) · N, then α_k *= exp(Δ · zscore(ω_k)). With N = D the
    first stage gives α_k = D_k, keeping α commensurate with the N_k of the
    M-step (neither dominant nor negligible).
    """
    n = pop.total_size if sample_size is None else int(sample_size)
    alpha = pop.dataset_sizes.astype(np.float64) / max(pop.total_size, 1) * n
    return straggler_lib.adjust_concentration(alpha, pop.delays, delta)


def lds_plan(pop: ClientPopulation, global_batch_size: int,
             delta: float = 0.0, tau: float = 1e-5,
             reinit: bool = False, seed: int = 0,
             sample_size: Optional[int] = None,
             max_em_iters: int = 10_000,
             backend: str = "numpy",
             record_pi_history: Optional[bool] = None,
             plan_format: str = "dense",
             em_client_chunk: Optional[int] = None,
             device="cuda"):
    """Latent Dirichlet Sampling (Algorithm 3).

    π is the MAP estimate of the mixture proportions under a Dir(α) prior,
    fitted by EM to the overall class counts ν (the paper always uses the
    complete label vector y = y_0; `sample_size` only rescales α's first
    stage when a sub-sample is modelled). On client depletion the component
    is removed and EM re-estimates π — warm-started from the running π when
    ``reinit=False`` (R=0), or re-drawn from the prior when ``reinit=True``
    (R=1).

    ``backend="jax"`` routes to the vectorized torch engine in
    :mod:`repro_torch.core.planner`, which keeps the chunked draws *and*
    every RemoveComponent EM re-estimation on ``device``; ``"auto"`` picks
    it for large K. ``record_pi_history`` only affects that engine (see
    :func:`repro_torch.core.planner.lds_plan_torch`); the NumPy path's
    history is per-re-estimation and always recorded, and it ignores
    ``device``.

    ``plan_format`` selects "dense" | "sparse" | "auto" plan storage (the
    draws are format-independent); ``em_client_chunk`` bounds MAP-EM's
    (K, M) intermediates by processing clients in chunks (same fixed point
    as the unchunked solve — see :func:`repro_torch.core.em.em_map`).
    """
    from repro_torch.core import planner as planner_lib
    if planner_lib.resolve_backend(backend, pop.num_clients) == "jax":
        return planner_lib.lds_plan_torch(
            pop, global_batch_size, delta=delta, tau=tau, reinit=reinit,
            seed=seed, sample_size=sample_size, max_em_iters=max_em_iters,
            record_pi_history=record_pi_history, plan_format=plan_format,
            em_client_chunk=em_client_chunk, device=device)
    rng = np.random.default_rng(seed)
    k = pop.num_clients
    b = int(global_batch_size)
    total = pop.total_size
    t_steps = _num_steps(total, b)

    beta = pop.class_distributions                      # (K, M)
    nu = pop.class_counts.sum(axis=0).astype(np.float64)  # (M,) counts of y_0
    if sample_size is not None:
        nu = nu / max(nu.sum(), 1.0) * float(sample_size)
    alpha = initialize_concentration(pop, delta, sample_size=sample_size)
    active = pop.dataset_sizes > 0

    def _draw_prior(active_mask: np.ndarray) -> np.ndarray:
        a = np.where(active_mask, np.maximum(alpha, _EPS), _EPS)
        pi = rng.dirichlet(a)
        pi = np.where(active_mask, pi, 0.0)
        return pi / max(pi.sum(), _EPS)

    em_total = 0
    pi = _draw_prior(active)
    res = em_lib.em_map(nu, pi, beta, alpha, tau=tau, max_iters=max_em_iters,
                        active=active, client_chunk=em_client_chunk)
    pi = res.pi
    em_total += res.iterations
    pi_history = [pi.copy()]

    fmt = resolve_plan_format(plan_format, t_steps, k)
    plan = SparsePlanBuilder(k) if fmt == "sparse" else \
        np.zeros((t_steps, k), dtype=np.int64)
    remaining = pop.dataset_sizes.copy()
    method_name = f"lds(delta={delta},R={int(reinit)})"
    for t in range(t_steps):
        budget = min(b, int(remaining.sum()))
        counts = np.zeros(k, dtype=np.int64)
        need = budget
        while need > 0:
            chunk = rng.multinomial(need, pi)
            take = np.minimum(chunk, remaining - counts)
            counts += take
            need -= int(take.sum())
            newly_depleted = ((remaining - counts) == 0) & active
            if newly_depleted.any():
                # RemoveComponent: drop depleted clients, re-estimate π.
                active = active & ~newly_depleted
                if not active.any():
                    break
                if reinit:
                    pi = _draw_prior(active)
                else:
                    pi = np.where(active, pi, 0.0)
                    pi = pi / max(pi.sum(), _EPS)
                res = em_lib.em_map(nu, pi, beta, alpha, tau=tau,
                                    max_iters=max_em_iters, active=active,
                                    client_chunk=em_client_chunk)
                pi = res.pi
                em_total += res.iterations
                pi_history.append(pi.copy())
        if fmt == "sparse":
            plan.add_step_counts(counts)
        else:
            plan[t] = counts
        remaining -= counts
    if fmt == "sparse":
        return plan.build(global_batch_size=b, method=method_name,
                          em_iterations=em_total, pi_history=pi_history)
    return EpochPlan(local_batch_sizes=plan, global_batch_size=b,
                     method=method_name,
                     em_iterations=em_total, pi_history=pi_history)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

def make_plan(method: str, pop: ClientPopulation, global_batch_size: int,
              seed: int = 0, backend: str = "numpy",
              plan_format: str = "dense", device="cuda", **kwargs):
    """Uniform entry point used by the data pipeline / trainer.

    ``backend`` selects the planner engine for the stochastic samplers:
    "numpy" (exact reference on the host, default), "jax" (the vectorized
    engine, torch on ``device`` — the card by default, and without CUDA it
    raises), or "auto" (that engine for K ≥
    ``planner.AUTO_BACKEND_MIN_CLIENTS``). The fixed baselines are
    deterministic rolls and always run on the host.

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
                        plan_format=plan_format, device=device)
    if method == "lds":
        return lds_plan(pop, global_batch_size, seed=seed, backend=backend,
                        plan_format=plan_format, device=device, **kwargs)
    if method == "fpls":
        return fpls_plan(pop, global_batch_size, plan_format=plan_format)
    if method == "fls":
        return fls_plan(pop, global_batch_size, plan_format=plan_format)
    raise ValueError(f"unknown sampling method: {method!r}")
