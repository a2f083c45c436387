"""Straggler model: delay assignment, concentration adjustment and the TPE
simulator (numpy copy of :mod:`repro.core.straggler`).

The paper (Sec. V-B) injects stragglers by selecting each client as a straggler
with probability p_s and assigning it a delay uniform in [w_min, w_max] ms; a
client waits for its delay before sending to the server. An optimization step
completes when the slowest *contributing* client has sent, so the per-batch
processing time is  base + max_{k: B_k^t > 0} omega_k,  and TPE is the sum
over the epoch's steps. LDS shifts stragglers' concentration parameters up so
their datasets deplete early and they drop out of later global batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np


def assign_delays(num_clients: int, p_straggler: float, w_min: float,
                  w_max: float, seed: int = 0) -> np.ndarray:
    """Sample per-client delays (ms). Non-stragglers get 0 (paper Sec. V-B)."""
    rng = np.random.default_rng(seed)
    is_straggler = rng.random(num_clients) < p_straggler
    delays = np.where(is_straggler,
                      rng.uniform(w_min, w_max, size=num_clients), 0.0)
    return delays.astype(np.float64)


def straggler_arrivals(num_requests: int, p_straggler: float = 0.2,
                       w_min: float = 50.0, w_max: float = 500.0,
                       seed: int = 0, time_scale: float = 1e-3) -> np.ndarray:
    """Arrival times (s) for a serving request trace with straggling clients.

    Each client straggles with probability ``p_straggler`` and its prompt
    arrives ``U[w_min, w_max]`` ms late (the Sec. V-B delays of
    :func:`assign_delays`); ``time_scale`` converts ms of model time into
    scheduler seconds.
    """
    delays_ms = assign_delays(num_requests, p_straggler, w_min, w_max,
                              seed=seed)
    return delays_ms * time_scale


def delay_zscores(delays: np.ndarray) -> np.ndarray:
    """Standardized delays; zero vector when all delays are equal."""
    delays = np.asarray(delays, dtype=np.float64)
    k = delays.shape[0]
    mean = delays.mean()
    if k < 2:
        return np.zeros_like(delays)
    std = delays.std(ddof=1)
    if std <= 0.0:
        return np.zeros_like(delays)
    return (delays - mean) / std


def adjust_concentration(alpha: np.ndarray, delays: np.ndarray,
                         delta: float) -> np.ndarray:
    """Second-stage alpha initialization (Sec. IV-D).

    alpha_k <- alpha_k * exp(Delta * zscore(omega_k)). Higher Delta pushes
    stragglers' selection probability up so they deplete (and drop out) early.
    """
    z = delay_zscores(delays)
    return np.asarray(alpha, dtype=np.float64) * np.exp(delta * z)


@dataclasses.dataclass(frozen=True)
class TPEResult:
    per_step_ms: np.ndarray    # (T,) processing time of each global batch
    total_ms: float            # TPE for the epoch
    contributing: np.ndarray   # (T,) number of clients with B_k^t > 0


def simulate_tpe(local_batch_sizes: np.ndarray, delays: np.ndarray,
                 base_step_ms: float = 60.0,
                 per_sample_ms: float = 0.0) -> TPEResult:
    """Simulate the training time per epoch for a given epoch plan.

    Args:
      local_batch_sizes: (T, K) plan matrix B_k^(t).
      delays: (K,) straggler delays in ms.
      base_step_ms: server+client compute/communication floor per step.
      per_sample_ms: optional per-sample client compute cost (scales with
        B_k^t, modelling weaker devices taking longer on bigger local batches).

    The step time is  base + max_k [ B_k^t > 0 ] * (omega_k + B_k^t * c ).
    """
    plan = np.asarray(local_batch_sizes)
    delays = np.asarray(delays, dtype=np.float64)
    contributing = plan > 0
    eff = contributing * (delays[None, :] + plan * per_sample_ms)
    per_step = base_step_ms + eff.max(axis=1)
    return TPEResult(per_step_ms=per_step, total_ms=float(per_step.sum()),
                     contributing=contributing.sum(axis=1).astype(np.int64))


def simulate_tpe_segments(plan, delays: np.ndarray,
                          base_step_ms: float = 60.0,
                          per_sample_ms: float = 0.0) -> TPEResult:
    """:func:`simulate_tpe` streamed off a plan's ``step_segments``.

    Identical result (only contributing clients — ``B_k^t > 0`` — enter
    the max, and a step's segment lists exactly those), but never touches
    ``plan.local_batch_sizes``, so it works unchanged on sparse
    million-client plans where the dense (T, K) matrix would not fit.
    Accepts any plan exposing ``num_steps`` and ``step_segments(t)``
    (EpochPlan and SparseEpochPlan both do).
    """
    delays = np.asarray(delays, dtype=np.float64)
    T = int(plan.num_steps)
    per_step = np.empty(T, np.float64)
    contributing = np.empty(T, np.int64)
    for t in range(T):
        ids, cnts = plan.step_segments(t)
        ids = np.asarray(ids, np.int64)
        cnts = np.asarray(cnts, np.float64)
        active = cnts > 0
        eff = delays[ids[active]] + cnts[active] * per_sample_ms
        per_step[t] = base_step_ms + (float(eff.max()) if eff.size else 0.0)
        contributing[t] = int(np.count_nonzero(active))
    return TPEResult(per_step_ms=per_step, total_ms=float(per_step.sum()),
                     contributing=contributing)
