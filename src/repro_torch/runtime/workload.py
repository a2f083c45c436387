"""Arrival-trace generators for serving workloads (numpy copy of
:mod:`repro.runtime.workload`; the straggler delay model is
:func:`repro_torch.core.straggler.assign_delays`, shared with training,
and its arrival trace :func:`repro_torch.core.straggler.straggler_arrivals`).

The straggler delay model answers "how late do clients run"; the arrival
processes answer "when do *serving* requests show up". Four classic arrival processes, all seeded, O(n), and returned
as a sorted float64 array of absolute arrival times so they drop straight
onto ``ServeRequest.arrival_s``:

* ``poisson`` — memoryless baseline, exponential inter-arrivals at
  ``rate_per_s``;
* ``bursty`` — on/off mixture: runs of ~``burst_size`` requests arrive
  ``burst_factor``× faster than nominal, separated by long gaps sized so
  the *long-run* mean rate still equals ``rate_per_s`` (bursts stress
  admission + preemption without changing offered load);
* ``diurnal`` — inhomogeneous Poisson with sinusoidal rate
  ``rate · (1 + depth·sin(2πt/period))`` via Ogata thinning (propose at
  the peak rate, accept proportionally — exact and seeded);
* ``heavy_tail`` — Pareto(α) inter-arrivals with the scale chosen so the
  mean matches ``1/rate_per_s``: rare huge gaps, occasional pile-ups.

``generate_arrivals`` dispatches on an ``ArrivalSpec``
(repro_torch.api.specs); the named generators stay importable for direct use.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.straggler import assign_delays, straggler_arrivals

__all__ = ["assign_delays", "straggler_arrivals", "generate_arrivals",
           "poisson_arrivals", "bursty_arrivals", "diurnal_arrivals",
           "heavy_tail_arrivals"]


def poisson_arrivals(n: int, rate_per_s: float,
                     seed: int = 0) -> np.ndarray:
    """Homogeneous Poisson process: exponential inter-arrival times."""
    _check(n, rate_per_s)
    rng = np.random.default_rng([int(seed), 0x9015])
    return np.cumsum(rng.exponential(1.0 / rate_per_s, size=n))


def bursty_arrivals(n: int, rate_per_s: float, burst_factor: float = 8.0,
                    burst_size: float = 16.0, seed: int = 0) -> np.ndarray:
    """On/off bursts at ``burst_factor``× the nominal rate.

    Inter-arrivals are a two-phase mixture: with probability
    ``1 - 1/burst_size`` the next request follows fast (rate
    ``rate·burst_factor`` — inside a burst), otherwise a long off-gap
    begins. The off-gap mean is solved so the mixture mean is exactly
    ``1/rate`` — burstiness reshapes the trace, not the offered load.
    """
    _check(n, rate_per_s)
    if burst_factor < 1.0:
        raise ValueError("burst_factor must be >= 1")
    if burst_size < 1.0:
        raise ValueError("burst_size must be >= 1")
    rng = np.random.default_rng([int(seed), 0x9016])
    p_off = 1.0 / float(burst_size)
    fast_mean = 1.0 / (rate_per_s * burst_factor)
    # (1-p)·fast_mean + p·off_mean = 1/rate  →  off_mean:
    off_mean = (1.0 / rate_per_s - (1.0 - p_off) * fast_mean) / p_off
    is_off = rng.random(n) < p_off
    dts = rng.exponential(1.0, size=n)
    dts *= np.where(is_off, off_mean, fast_mean)
    return np.cumsum(dts)


def diurnal_arrivals(n: int, rate_per_s: float, period_s: float = 10.0,
                     depth: float = 0.8, seed: int = 0) -> np.ndarray:
    """Sinusoidal-rate inhomogeneous Poisson via Ogata thinning.

    Instantaneous rate ``λ(t) = rate·(1 + depth·sin(2πt/period))``;
    proposals are drawn at the peak rate ``rate·(1+depth)`` and accepted
    with probability ``λ(t)/λ_max`` — exact, and O(n) in expectation
    since the acceptance rate is bounded below by ``(1-depth)/(1+depth)``.
    """
    _check(n, rate_per_s)
    if period_s <= 0:
        raise ValueError("period_s must be positive")
    if not 0.0 <= depth < 1.0:
        raise ValueError("depth must be in [0, 1)")
    rng = np.random.default_rng([int(seed), 0x9017])
    lam_max = rate_per_s * (1.0 + depth)
    omega = 2.0 * np.pi / period_s
    out = np.empty(n)
    t, k = 0.0, 0
    while k < n:
        t += rng.exponential(1.0 / lam_max)
        lam_t = rate_per_s * (1.0 + depth * np.sin(omega * t))
        if rng.random() * lam_max <= lam_t:
            out[k] = t
            k += 1
    return out


def heavy_tail_arrivals(n: int, rate_per_s: float, alpha: float = 1.5,
                        seed: int = 0) -> np.ndarray:
    """Pareto(α) inter-arrivals with the mean pinned to ``1/rate``.

    Classic Pareto with minimum ``x_m = (α-1)/(α·rate)`` so
    ``E[dt] = α·x_m/(α-1) = 1/rate``; α ≤ 2 gives infinite variance —
    the occasional enormous gap followed by a backlog flush.
    """
    _check(n, rate_per_s)
    if alpha <= 1.0:
        raise ValueError("alpha must be > 1 (finite mean)")
    rng = np.random.default_rng([int(seed), 0x9018])
    x_m = (alpha - 1.0) / (alpha * rate_per_s)
    dts = (rng.pareto(alpha, size=n) + 1.0) * x_m
    return np.cumsum(dts)


def generate_arrivals(spec, n: int) -> np.ndarray:
    """Arrival times for ``n`` requests per an ``ArrivalSpec``.

    Dispatches on ``spec.process``; every generator is a pure function of
    (spec, n), so the same spec always reproduces the same trace.
    """
    proc = spec.process
    if proc == "poisson":
        return poisson_arrivals(n, spec.rate_per_s, spec.seed)
    if proc == "bursty":
        return bursty_arrivals(n, spec.rate_per_s, spec.burst_factor,
                               spec.burst_size, spec.seed)
    if proc == "diurnal":
        return diurnal_arrivals(n, spec.rate_per_s, spec.period_s,
                                spec.depth, spec.seed)
    if proc == "heavy_tail":
        return heavy_tail_arrivals(n, spec.rate_per_s, spec.alpha,
                                   spec.seed)
    raise ValueError(f"unknown arrival process {proc!r}")


def _check(n: int, rate_per_s: float) -> None:
    if n < 0:
        raise ValueError("n must be >= 0")
    if rate_per_s <= 0:
        raise ValueError("rate_per_s must be positive")
