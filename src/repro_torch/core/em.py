"""EM algorithm for MAP estimation of client selection probabilities (LDS).

Implements Algorithm 2 of the paper with the class-wise responsibility
reformulation (Eq. 5): responsibilities are computed per *class* rather than
per sample, giving O(K*M) per iteration instead of O(N*K).

Two implementations (the port of :mod:`repro.core.em`):
  * ``em_map`` — numpy, float64, the host-side reference; a copy of
    ``repro``'s, bit for bit.
  * ``em_map_torch`` / ``em_update_torch`` — float32 torch tensor code on
    the tensors' device, the counterpart of ``repro``'s ``em_map_jax`` /
    ``em_update_jax``: the same two-matvec E+M step, clamps, client
    chunking and iteration accounting. The vectorized epoch planner
    (:mod:`repro_torch.core.planner`) runs every RemoveComponent
    re-estimation through it on the card.

M-step (Proposition 1):  pi_k = (N_k + alpha_k - 1) / (N + alpha_0 - K)
with N_k = nu^T gamma_hat_k.

Note on alpha < 1: the closed-form M-step can produce negative components when
some alpha_k < 1 (the Dirichlet MAP sits on the simplex boundary). The paper's
initialization (alpha_k = D_k/D * N) keeps alpha_k >= 1 for non-empty clients,
but the exponential delay adjustment can push small clients below 1. We follow
standard practice and clamp to a tiny floor before renormalizing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

_EPS = 1e-12
_PI_FLOOR = 1e-12


@dataclasses.dataclass(frozen=True)
class EMResult:
    pi: np.ndarray
    iterations: int
    converged: bool


def _m_step_np(n_k: np.ndarray, alpha: np.ndarray, n_total: float,
               active: np.ndarray) -> np.ndarray:
    k_active = int(active.sum())
    alpha0 = float(alpha[active].sum())
    denom = n_total + alpha0 - k_active
    pi = np.where(active, (n_k + alpha - 1.0) / max(denom, _EPS), 0.0)
    pi = np.maximum(pi, np.where(active, _PI_FLOOR, 0.0))
    return pi / max(pi.sum(), _EPS)


def em_map(nu: np.ndarray, pi_init: np.ndarray, beta: np.ndarray,
           alpha: np.ndarray, tau: float = 1e-5, max_iters: int = 10_000,
           active: Optional[np.ndarray] = None,
           client_chunk: Optional[int] = None) -> EMResult:
    """MAP-EM for the mixture proportions pi (Algorithm 2, class-wise form).

    Args:
      nu:    (M,) class counts of the observed label vector y.
      pi_init: (K,) initial mixture proportions (on the simplex over `active`).
      beta:  (K, M) per-client class distributions.
      alpha: (K,) Dirichlet concentration parameters.
      tau:   convergence threshold on ||pi_new - pi_old||_2.
      active: (K,) bool mask of alive mixture components (non-depleted
        clients). Inactive components are held at exactly 0.
      client_chunk: when set, the E-step processes clients in chunks of this
        size so peak temporary memory is O(client_chunk · M) instead of
        O(K · M). Same fixed point and iteration count as the unchunked
        solve up to summation-order rounding.
    """
    nu = np.asarray(nu, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    alpha = np.asarray(alpha, dtype=np.float64)
    k = pi_init.shape[0]
    if active is None:
        active = np.ones(k, dtype=bool)
    pi_new = np.where(active, pi_init, 0.0)
    pi_new = pi_new / max(pi_new.sum(), _EPS)
    n_total = float(nu.sum())
    chunked = client_chunk is not None and 0 < int(client_chunk) < k

    iters = 0
    converged = False
    while iters < max_iters:
        pi_old = pi_new
        if chunked:
            # Two streaming passes over client chunks: the mixture
            # marginal, then the responsibility-weighted counts.
            c = int(client_chunk)
            mix = np.zeros_like(nu)
            for s in range(0, k, c):
                mix += pi_old[s:s + c] @ beta[s:s + c]
            scaled = nu / np.maximum(mix, _EPS)
            n_k = np.empty(k, dtype=np.float64)
            for s in range(0, k, c):
                n_k[s:s + c] = pi_old[s:s + c] * (beta[s:s + c] @ scaled)
        else:
            # E-step: class-wise responsibilities gamma_hat (K, M), Eq. (5).
            w = pi_old[:, None] * beta                      # (K, M)
            denom = np.maximum(w.sum(axis=0, keepdims=True), _EPS)
            gamma_hat = w / denom
            n_k = gamma_hat @ nu                            # (K,)
        # M-step: Proposition 1.
        pi_new = _m_step_np(n_k, alpha, n_total, active)
        iters += 1
        if np.linalg.norm(pi_new - pi_old) < tau:
            converged = True
            break
    return EMResult(pi=pi_new, iterations=iters, converged=converged)


def log_posterior(pi: np.ndarray, nu: np.ndarray, beta: np.ndarray,
                  alpha: np.ndarray, active: Optional[np.ndarray] = None
                  ) -> float:
    """ln P(y | pi, beta) + ln P(pi | alpha) up to the Beta-function constant.

    Used by tests to assert EM monotonically increases the posterior.
    """
    if active is None:
        active = np.ones(pi.shape[0], dtype=bool)
    mix = np.maximum((pi[active, None] * beta[active]).sum(axis=0), _EPS)
    loglik = float((nu * np.log(mix)).sum())
    pa = np.maximum(pi[active], _EPS)
    logprior = float(((alpha[active] - 1.0) * np.log(pa)).sum())
    return loglik + logprior


# ---------------------------------------------------------------------------
# torch implementation (float32 on the tensors' device)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanCounts:
    """Host round trips of the torch planner and its EM, summed over the
    calls given this object: draw ``rounds`` (one a trip of a step's
    ``while need > 0``), integer-CDF ``refreshes`` (UGS), RemoveComponent
    ``replans`` (LDS), ``em_trips`` (one a trip of EM's convergence loop),
    and ``syncs``, the device values the host waits for (one a round, a
    refresh and an EM trip, and one to fetch the plan)."""
    rounds: int = 0
    refreshes: int = 0
    replans: int = 0
    em_trips: int = 0
    syncs: int = 0


def em_update_torch(nu: torch.Tensor, pi_init: torch.Tensor,
                    beta: torch.Tensor, alpha: torch.Tensor,
                    active: torch.Tensor, tau: float, max_iters: int,
                    client_chunk: Optional[int] = None,
                    counts: Optional[PlanCounts] = None
                    ) -> Tuple[torch.Tensor, int, float]:
    """MAP-EM core on float32 tensors: (pi, iterations, final ||Δpi||).

    The counterpart of ``repro``'s ``em_update_jax``, step for step: the E+M
    update in matvec form (``mix = betaᵀπ``, ``n_k = π·(β(ν/mix))``), the
    ``_PI_FLOOR`` / ``_EPS`` clamps, two updates a loop trip with the
    single-step movement ||π₂ − π₁|| checked against ``tau`` after each
    trip while ``it + 1 < max_iters``, then the odd last update of the
    budget. So ``iterations`` counts what ``repro``'s engine counts. The
    loop's condition is read on the host once a trip (``counts.em_trips``,
    ``counts.syncs``); everything else stays on the tensors' device. The
    M-step multiplies by 1 / (N + α₀ − K) where ``repro`` divides by it
    (one rounding apart). ``client_chunk`` runs
    the two matvecs over client chunks of that size, in ``repro``'s order
    (O(client_chunk · M) temporaries).
    """
    f32 = torch.float32
    nu = nu.to(f32)
    beta = beta.to(f32)
    alpha = alpha.to(f32)
    active = active.to(torch.bool)
    # the loop compares a float32 norm with tau in float32, as XLA does
    tau32 = float(np.float32(tau))

    pi0 = torch.where(active, pi_init.to(f32), 0.0)
    pi0 = pi0 / pi0.sum().clamp_min(_EPS)
    n_total = nu.sum()
    k_active = active.sum().to(f32)
    alpha0 = torch.where(active, alpha, 0.0).sum()
    denom_m = (n_total + alpha0 - k_active).clamp_min(_EPS)
    floor = torch.where(active, _PI_FLOOR, 0.0)
    # constants of this solve, so an update launches the fewest kernels:
    # the loop is bound by the host's launches, not the card
    shift = alpha - 1.0
    inv_denom = 1.0 / denom_m

    def m_step(n_k):
        pi = torch.where(active, (n_k + shift) * inv_denom, 0.0)
        pi = torch.maximum(pi, floor)
        return pi / pi.sum().clamp_min(_EPS)

    k = pi0.shape[0]
    if client_chunk is not None and 0 < int(client_chunk) < k:
        c = int(client_chunk)
        starts = range(0, k, c)

        def update(pi_old):
            mix = torch.zeros_like(nu)
            for s in starts:
                mix = mix + pi_old[s:s + c] @ beta[s:s + c]
            scaled = nu / mix.clamp_min(_EPS)
            return m_step(torch.cat([pi_old[s:s + c] * (beta[s:s + c]
                                                        @ scaled)
                                     for s in starts]))
    else:
        beta_t = beta.t()

        def update(pi_old):
            mix = (beta_t @ pi_old).clamp_min(_EPS)           # (M,)
            return m_step(pi_old * (beta @ (nu / mix)))       # (K,)

    counts = PlanCounts() if counts is None else counts
    pi, it, delta = pi0, 0, float("inf")
    while it + 1 < max_iters and delta >= tau32:
        pi_mid = update(pi)
        pi = update(pi_mid)
        delta = float(torch.linalg.vector_norm(pi - pi_mid))
        it += 2
        counts.em_trips += 1
        counts.syncs += 1
    if it < max_iters and delta >= tau32:
        pi_new = update(pi)
        delta = float(torch.linalg.vector_norm(pi_new - pi))
        pi, it = pi_new, it + 1
        counts.em_trips += 1
        counts.syncs += 1
    return pi, it, delta


def em_map_torch(nu, pi_init, beta, alpha, tau: float = 1e-5,
                 max_iters: int = 10_000, active=None,
                 client_chunk: Optional[int] = None,
                 device="cuda") -> Tuple[torch.Tensor, int, bool]:
    """torch twin of :func:`em_map`: (pi, iterations, converged).

    Takes numpy arrays or tensors and solves in float32 on ``device``
    (resolved by :func:`repro_torch.device.resolve_device`: the card by
    default, and without CUDA it raises; the tests pass ``"cpu"``).
    """
    from repro_torch.device import resolve_device
    dev = resolve_device(device)

    def put(x, dtype=torch.float32):
        return torch.as_tensor(x).to(device=dev, dtype=dtype)

    pi0 = put(pi_init)
    k = pi0.shape[0]
    act = (torch.ones(k, dtype=torch.bool, device=dev) if active is None
           else put(active, torch.bool))
    pi, iters, delta = em_update_torch(put(nu), pi0, put(beta), put(alpha),
                                       act, tau, int(max_iters),
                                       client_chunk=client_chunk)
    return pi, iters, delta < float(np.float32(tau))
