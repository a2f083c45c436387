"""Batch-deviation analytics (Sec. IV-A of the paper; numpy copy of
:mod:`repro.core.deviation`, bit for bit).

Deviation of a batch's class histogram from the overall class distribution,
the Chebyshev/Markov bounds of Lemmas 1–2, the Serfling bounds the live
GPSL monitor holds batches to, and Monte-Carlo evaluation of an epoch
plan's deviation statistics (Figs. 6–7).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.types import ClientPopulation, EpochPlan


def batch_deviation(class_counts: np.ndarray, beta0: np.ndarray) -> np.ndarray:
    """L1 deviation d(B, beta0) (Eq. 1). Supports batched inputs (..., M)."""
    counts = np.asarray(class_counts, dtype=np.float64)
    sizes = np.maximum(counts.sum(axis=-1, keepdims=True), 1.0)
    return np.abs(counts / sizes - beta0).sum(axis=-1)


def lemma1_bound(batch_size: int, beta0: np.ndarray, eps: float) -> np.ndarray:
    """Central uniform sampling: P(|Y_m/B - b0m| >= eps) <= Var(Y_m)/(B²ε²)."""
    var = batch_size * beta0 * (1.0 - beta0)
    return var / (batch_size ** 2 * eps ** 2)


def lemma2_terms(local_batch_sizes: np.ndarray, beta: np.ndarray,
                 beta0: np.ndarray) -> dict:
    """Variance and bias terms of the Lemma-2 bound for fixed plans.

    Args:
      local_batch_sizes: (K,) fixed per-client batch sizes B_k.
      beta: (K, M) client class distributions.
      beta0: (M,) overall class distribution.
    Returns dict with 'variance' (M,), 'bias_sq' (M,), and 'central_variance'.
    """
    bk = np.asarray(local_batch_sizes, dtype=np.float64)[:, None]
    b = float(bk.sum())
    var = (bk * beta * (1.0 - beta)).sum(axis=0)          # Var(Y'_m)
    mean = (bk * beta).sum(axis=0)                        # E[Y'_m]
    bias_sq = (mean - b * beta0) ** 2                     # (E[Y'_m]-E[Y_m])²
    central_var = b * beta0 * (1.0 - beta0)               # Var(Y_m)
    return {"variance": var, "bias_sq": bias_sq,
            "central_variance": central_var, "batch_size": b}


def lemma2_bound(local_batch_sizes: np.ndarray, beta: np.ndarray,
                 beta0: np.ndarray, eps: float) -> np.ndarray:
    t = lemma2_terms(local_batch_sizes, beta, beta0)
    return (t["variance"] + t["bias_sq"]) / (t["batch_size"] ** 2 * eps ** 2)


def serfling_bound(batch_size: int, total: int, eps: float) -> float:
    """Serfling (1974) tail bound for sampling without replacement.

    For B draws uniformly without replacement from a population of D items,
    of which a fraction β_0m belong to class m,

        P(|Y_m/B − β_0m| ≥ ε) ≤ 2·exp(−2Bε² / (1 − (B−1)/D)).

    This is the paper's distributional-equivalence guarantee for a GPSL
    global batch: its class histogram concentrates around β_0 exactly as a
    centralized uniform without-replacement batch does (and *tighter* than
    the with-replacement Hoeffding bound by the finite-population factor).
    """
    b = int(batch_size)
    d = max(int(total), 1)
    f = max(1.0 - (b - 1.0) / d, 1e-12)
    return float(2.0 * np.exp(-2.0 * b * eps * eps / f))


def serfling_epsilon(batch_size: int, total: int, delta: float) -> float:
    """Invert :func:`serfling_bound`: the ε with tail mass exactly δ."""
    b = int(batch_size)
    d = max(int(total), 1)
    f = max(1.0 - (b - 1.0) / d, 1e-12)
    return float(np.sqrt(f * np.log(2.0 / delta) / (2.0 * b)))


@dataclasses.dataclass(frozen=True)
class DeviationStats:
    mean: float
    std: float
    per_step: np.ndarray


def simulate_plan_deviation(plan: EpochPlan, pop: ClientPopulation,
                            seed: int = 0,
                            with_replacement: bool = False) -> DeviationStats:
    """Monte-Carlo the class composition of the global batches under a plan.

    Clients sample locally uniformly *without replacement* (multivariate
    hypergeometric over their remaining class counts), exactly as in PSL
    step 1; the resulting global-batch class counts are measured against
    beta_0. ``with_replacement=True`` switches to the multinomial
    approximation used in the paper's analysis.

    Accepts dense and sparse plans alike: draws stream the per-step
    active-client segments in ascending client order — the same clients in
    the same order as a dense row scan that skips zero rows, so results
    are bit-identical across plan formats.
    """
    rng = np.random.default_rng(seed)
    beta0 = pop.overall_distribution
    remaining = pop.class_counts.copy()                   # (K, M)
    t_steps = plan.num_steps
    m = pop.num_classes
    devs = np.zeros(t_steps)
    for t in range(t_steps):
        counts = np.zeros(m, dtype=np.int64)
        ids, cnts = plan.step_segments(t)
        for ki, n in zip(ids, cnts):
            ki = int(ki)
            n = int(n)
            if with_replacement:
                p = remaining[ki] / max(remaining[ki].sum(), 1)
                draw = rng.multinomial(n, p)
            else:
                avail = int(remaining[ki].sum())
                n = min(n, avail)
                if n == 0:
                    continue
                draw = rng.multivariate_hypergeometric(remaining[ki], n)
                remaining[ki] -= draw
            counts += draw
        devs[t] = batch_deviation(counts, beta0)
    return DeviationStats(mean=float(devs.mean()), std=float(devs.std()),
                          per_step=devs)
