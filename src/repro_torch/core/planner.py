"""Vectorized planner engine for global sampling (UGS / LDS) in torch.

The port of :mod:`repro.core.planner`: the same algorithm as ``repro``'s
jit-compiled engine, written as eager torch tensor code on the card. The
NumPy samplers in :mod:`repro_torch.core.sampling` stay the reference.
``backend="jax"`` (the value ``repro``'s specs use) selects this engine,
and ``"auto"`` selects it from ``AUTO_BACKEND_MIN_CLIENTS`` clients on.

Design (UGS, Algorithm 1):
  * selection probabilities are an *exact integer CDF* (int32 cumsum of
    the sizes of non-depleted clients) and slots are drawn by integer
    inverse-CDF sampling: ``torch.randint`` + ``torch.searchsorted``. No
    floating-point renormalization: P(z=k) = w_k / W exactly;
  * the CDF is *frozen* across draw rounds: a draw landing on a client
    that depleted since the freeze is rejected, which conditions the
    categorical on the alive set — the renormalized distribution of
    Algorithm 1. The CDF is recomputed only when a round fills fewer than
    half of the slots it was asked for;
  * each round draws an *overdrawn* chunk of C = max(3B/2, B+1)
    candidates, keeps the first ``need`` valid ones in draw order, caps
    each client at what it has left, and loops only for the capping
    deficit.

Design (LDS, Algorithm 3): the same round loop over a float CDF of the
EM-estimated π (B uniform draws a round; the CDF is a blocked cumsum
that adds in the same order on every call, :class:`_FloatCDF`), with
every RemoveComponent
event re-estimating π by :func:`repro_torch.core.em.em_update_torch` on
the card — warm-started from π (R=0) or from a fresh prior draw (R=1).

The loop conditions (a step's ``while need > 0``, EM's convergence check)
are read on the host, one device value a trip, where ``repro``'s engine
keeps them inside one compiled program. :class:`PlanCounts` counts those
round trips. Everything else — draws, CDFs, counts, EM, sparse
compaction — stays on the card; the plan comes to the host once.

Randomness: one ``torch.Generator`` on the device, seeded from ``seed``
and consumed in the same order whatever the plan format, so dense and
sparse plans of a seed are bit-identical. Torch's generators are not
JAX's, so plans differ draw by draw from ``repro``'s engine and agree in
distribution (tests/test_torch_planner.py).

Invariants (as the NumPy backend): every non-final plan row sums to
exactly B, the final row to D mod B (or B), and columns sum to the client
dataset sizes. Plans are int32; LDS's EM runs in float32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.em import PlanCounts, em_update_torch
from repro_torch.core.sampling import (_num_steps, initialize_concentration,
                                       resolve_plan_format)
from repro_torch.core.types import (ClientPopulation, EpochPlan,
                                    SparseEpochPlan)
from repro_torch.device import resolve_device

__all__ = ["AUTO_BACKEND_MIN_CLIENTS", "PlanCounts", "lds_plan_torch",
           "resolve_backend", "ugs_plan_torch"]

_EPS = 1e-12

# Overdraw factor: each UGS draw round samples C = B * _OVERDRAW_NUM //
# _OVERDRAW_DEN candidates so that stale-CDF rejections are absorbed in one
# round and the loop iterates only for capping deficits.
_OVERDRAW_NUM = 3
_OVERDRAW_DEN = 2

# Above this many (T, K) entries the per-step π history is not recorded by
# default — at large scale it would rival the plan itself in memory.
_PI_HISTORY_MAX_ENTRIES = 32_000_000

# Population size from which ``backend="auto"`` picks the vectorized engine
# (``repro``'s threshold, kept).
AUTO_BACKEND_MIN_CLIENTS = 4096


def resolve_backend(backend: str, num_clients: int) -> str:
    """Map a requested backend ("numpy" | "jax" | "auto") to a concrete one.

    "jax" is the vectorized torch engine of this module (the name is
    ``repro``'s, so its specs load unchanged).
    """
    backend = backend.lower()
    if backend == "auto":
        return "jax" if num_clients >= AUTO_BACKEND_MIN_CLIENTS else "numpy"
    if backend not in ("numpy", "jax"):
        raise ValueError(f"unknown planner backend: {backend!r}")
    return backend


def _check_total(pop: ClientPopulation) -> None:
    if pop.total_size >= np.iinfo(np.int32).max:
        raise ValueError("the vectorized planner requires total dataset "
                         "size < 2^31")


class _StepSink:
    """Where a plan's per-step (K,) counts go, on the device: the dense
    (T, K) rows, or padded active-client segments of S = min(B, K) slots
    (client id, count) in ascending client order, -1 / 0 past the step's
    active clients. Compaction is a cumsum of ``c > 0`` and a scatter into
    the S slots (a dump slot S takes the rest), so no step waits for the
    host."""

    def __init__(self, fmt: str, t_steps: int, k: int, b: int, dev):
        self.sparse = fmt == "sparse"
        self.k = k
        if self.sparse:
            self.seg = min(b, k)
            self.ids = torch.full((t_steps, self.seg), -1, dtype=torch.int32,
                                  device=dev)
            self.cnts = torch.zeros((t_steps, self.seg), dtype=torch.int32,
                                    device=dev)
            self.client = torch.arange(k, dtype=torch.int32, device=dev)
        else:
            self.rows = torch.zeros((t_steps, k), dtype=torch.int32,
                                    device=dev)

    def put(self, t: int, c: torch.Tensor) -> None:
        if not self.sparse:
            self.rows[t] = c
            return
        live = c > 0
        slot = torch.where(live, torch.cumsum(live, 0) - 1, self.seg)
        ids = torch.full((self.seg + 1,), -1, dtype=torch.int32,
                         device=c.device)
        cnts = torch.zeros(self.seg + 1, dtype=torch.int32, device=c.device)
        ids.scatter_(0, slot, self.client)
        cnts.scatter_(0, slot, c)
        self.ids[t] = ids[:self.seg]
        self.cnts[t] = cnts[:self.seg]

    def plan(self, counts: PlanCounts, **fields):
        """Fetch the plan to the host (one sync) as an EpochPlan or a
        SparseEpochPlan."""
        counts.syncs += 1
        if not self.sparse:
            return EpochPlan(local_batch_sizes=self.rows.cpu().numpy(),
                             **fields)
        offsets, ids, cnts = _sparse_plan_from_padded(
            self.ids.cpu().numpy(), self.cnts.cpu().numpy())
        return SparseEpochPlan(step_offsets=offsets, client_ids=ids,
                               draw_counts=cnts, num_clients=self.k,
                               **fields)


class _FloatCDF:
    """cumsum(π) in float32 with the same additions on every call.

    torch's cumsum of a 1-D CUDA tensor is a CUB scan whose float sums may
    associate differently from one call to the next (decoupled look-back
    across tiles), so LDS plans of one seed could differ between runs, and
    between their dense and sparse forms. Here one block scans each row of
    ``row`` clients in a fixed order (a 2-D cumsum), and each row is offset
    by the sum of the rows before it through a product with a fixed
    strictly upper-triangular matrix (cuBLAS, TF32 off: deterministic).
    Rows of max(1024, ⌈√K⌉) keep that matrix no larger than π.
    """

    def __init__(self, k: int, dev):
        self.k = k
        self.row = max(1024, int(np.ceil(np.sqrt(k))))
        self.rows = max(2, -(-k // self.row))
        self.upper = torch.ones(self.rows, self.rows,
                                device=dev).triu_(1)

    def __call__(self, pi: torch.Tensor) -> torch.Tensor:
        x = torch.nn.functional.pad(pi, (0, self.rows * self.row - self.k))
        x = x.view(self.rows, self.row).cumsum(1)
        x += (x[:, -1] @ self.upper)[:, None]
        return x.view(-1)[:self.k]


def _sparse_plan_from_padded(ids_h: np.ndarray,
                             cnts_h: np.ndarray) -> tuple:
    """Host-side (T, S) padded segments → flat CSR-style arrays."""
    mask = cnts_h > 0
    step_nnz = mask.sum(axis=1)
    step_offsets = np.concatenate([np.zeros(1, np.int64),
                                   np.cumsum(step_nnz, dtype=np.int64)])
    # Row-major flatten keeps per-step ascending client-id order.
    return step_offsets, ids_h[mask].astype(np.int32), \
        cnts_h[mask].astype(np.int32)


def ugs_plan_torch(pop: ClientPopulation, global_batch_size: int,
                   seed: int = 0, plan_format: str = "dense",
                   device="cuda", counts: Optional[PlanCounts] = None):
    """Uniform Global Sampling (Algorithm 1) on ``device``.

    The distributional equivalent of
    :func:`repro_torch.core.sampling.ugs_plan` and the counterpart of
    ``repro``'s ``ugs_plan_jax``. ``device`` goes through
    :func:`repro_torch.device.resolve_device` (the card by default; without
    CUDA it raises). ``plan_format="sparse"`` keeps device output and host
    plan at O(T·B), with draws bit-identical to the dense path. ``counts``
    (a :class:`PlanCounts`) accumulates the plan's rounds, CDF refreshes
    and host syncs.
    """
    dev = resolve_device(device)
    _check_total(pop)
    counts = PlanCounts() if counts is None else counts
    b = int(global_batch_size)
    k = pop.num_clients
    t_steps = _num_steps(pop.total_size, b)
    sink = _StepSink(resolve_plan_format(plan_format, t_steps, k), t_steps,
                     k, b, dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    chunk = max(b * _OVERDRAW_NUM // _OVERDRAW_DEN, b + 1)
    sizes = torch.as_tensor(pop.dataset_sizes).to(dev, torch.int32)

    def fresh_cdf(rem):
        # Exact integer CDF over non-depleted clients; client k owns the
        # half-open interval [cdf_{k-1}, cdf_k) of width w_k.
        cdf = torch.cumsum(torch.where(rem > 0, sizes, 0), 0,
                           dtype=torch.int32)
        counts.refreshes += 1
        counts.syncs += 1
        return cdf, int(cdf[-1])

    rem = sizes
    rem_sum = pop.total_size
    cdf, cdf_total = fresh_cdf(rem)
    for t in range(t_steps):
        rem_in = rem
        need = min(b, rem_sum)
        while need > 0:
            u = torch.randint(0, max(cdf_total, 1), (chunk,), generator=gen,
                              device=dev, dtype=torch.int32)
            z = torch.searchsorted(cdf, u, right=True).clamp_(max=k - 1)
            # Reject draws on clients that depleted since the CDF froze
            # (conditioning == renormalizing), then keep the first `need`
            # valid candidates in draw order.
            valid = rem[z] > 0
            keep = valid & (torch.cumsum(valid, 0) <= need)
            drawn = torch.zeros(k, dtype=torch.int32, device=dev).index_add_(
                0, z, keep.to(torch.int32))
            # take = min(drawn, rem) fused into the rem update; the number
            # of filled slots falls out of the running total
            rem_next = (rem - drawn).clamp_(min=0)
            got = int((rem - rem_next).sum())
            counts.rounds += 1
            counts.syncs += 1
            rem, rem_sum = rem_next, rem_sum - got
            need_next = need - got
            # Refresh the CDF when under half the requested slots were
            # filled; also guarantees progress (got == 0 refreshes).
            if need_next > 0 and 2 * got < need:
                cdf, cdf_total = fresh_cdf(rem)
            need = need_next
        sink.put(t, rem_in - rem)
    return sink.plan(counts, global_batch_size=b, method="ugs")


def lds_plan_torch(pop: ClientPopulation, global_batch_size: int,
                   delta: float = 0.0, tau: float = 1e-5,
                   reinit: bool = False, seed: int = 0,
                   sample_size: Optional[int] = None,
                   max_em_iters: int = 10_000,
                   record_pi_history: Optional[bool] = None,
                   plan_format: str = "dense",
                   em_client_chunk: Optional[int] = None,
                   device="cuda", counts: Optional[PlanCounts] = None):
    """Latent Dirichlet Sampling (Algorithm 3) on ``device``.

    The distributional equivalent of
    :func:`repro_torch.core.sampling.lds_plan` and the counterpart of
    ``repro``'s ``lds_plan_jax``: prior draw (Dirichlet(α) from normalised
    gamma draws on the device's generator, floored at ``_EPS``), MAP-EM,
    chunked depletion-aware draws, and EM replanning on every
    RemoveComponent, all on the card. ``pi_history`` holds the initial π
    followed by the π in effect after each step (the NumPy backend
    records one entry per re-estimation). ``record_pi_history=None``
    (auto) skips the per-step history when the (T, K) matrix would exceed
    ``_PI_HISTORY_MAX_ENTRIES``, leaving only the initial π.

    ``plan_format="sparse"`` emits per-step active-client segments (see
    :func:`ugs_plan_torch`); ``em_client_chunk`` bounds EM's (K, M)
    intermediates by processing clients in chunks of that size; ``device``
    and ``counts`` as in :func:`ugs_plan_torch` (``counts`` also takes the
    replans and EM trips).
    """
    dev = resolve_device(device)
    _check_total(pop)
    counts = PlanCounts() if counts is None else counts
    f32 = torch.float32
    b = int(global_batch_size)
    k = pop.num_clients
    t_steps = _num_steps(pop.total_size, b)
    sink = _StepSink(resolve_plan_format(plan_format, t_steps, k), t_steps,
                     k, b, dev)
    if record_pi_history is None:
        record_pi_history = t_steps * k <= _PI_HISTORY_MAX_ENTRIES
    gen = torch.Generator(device=dev).manual_seed(int(seed))

    nu_h = pop.class_counts.sum(axis=0).astype(np.float64)
    if sample_size is not None:
        nu_h = nu_h / max(nu_h.sum(), 1.0) * float(sample_size)
    nu = torch.as_tensor(nu_h).to(dev, f32)
    beta = torch.as_tensor(pop.class_distributions).to(dev, f32)
    alpha = torch.as_tensor(initialize_concentration(
        pop, delta, sample_size=sample_size)).to(dev, f32)
    sizes = torch.as_tensor(pop.dataset_sizes).to(dev, torch.int32)
    lanes = torch.arange(b, device=dev)

    def draw_prior(active):
        a = torch.where(active, alpha.clamp_min(_EPS), _EPS)
        g = torch._standard_gamma(a, generator=gen)
        pi = g / g.sum().clamp_min(torch.finfo(f32).tiny)
        pi = torch.where(active, pi, 0.0)
        return pi / pi.sum().clamp_min(_EPS)

    def run_em(base, active):
        pi, iters, _ = em_update_torch(nu, base, beta, alpha, active, tau,
                                       int(max_em_iters),
                                       client_chunk=em_client_chunk,
                                       counts=counts)
        return pi, iters

    active = sizes > 0
    pi, em_total = run_em(draw_prior(active), active)
    pi0 = pi
    cdf_of = _FloatCDF(k, dev)
    cdf = cdf_of(pi)
    pi_steps = (torch.empty((t_steps, k), dtype=f32, device=dev)
                if record_pi_history else None)

    remaining = sizes
    rem_total = pop.total_size
    for t in range(t_steps):
        need = min(b, rem_total)
        rem_total -= need
        step = torch.zeros(k, dtype=torch.int32, device=dev)
        while need > 0:
            u = torch.rand(b, generator=gen, device=dev) * cdf[-1]
            z = torch.searchsorted(cdf, u, right=True).clamp_(max=k - 1)
            drawn = torch.zeros(k, dtype=torch.int32, device=dev).index_add_(
                0, z, (lanes < need).to(torch.int32))
            take = torch.minimum(drawn, remaining - step)
            step = step + take
            newly = ((remaining - step) == 0) & active
            active = active & ~newly
            got, any_new, any_alive = torch.stack(
                [take.sum(), newly.any(), active.any()]).tolist()
            counts.rounds += 1
            counts.syncs += 1
            need -= int(got)
            if any_new and any_alive:
                # RemoveComponent: drop depleted clients, re-estimate π.
                counts.replans += 1
                if reinit:                      # R=1: re-draw from prior
                    base = draw_prior(active)
                else:                           # R=0: warm-start from π
                    base = torch.where(active, pi, 0.0)
                    base = base / base.sum().clamp_min(_EPS)
                pi, iters = run_em(base, active)
                em_total += iters
                cdf = cdf_of(pi)
        remaining = remaining - step
        sink.put(t, step)
        if pi_steps is not None:
            pi_steps[t] = pi
    pi_hist = [pi0.double().cpu().numpy()]
    if pi_steps is not None:
        pi_hist += list(pi_steps.double().cpu().numpy())
    return sink.plan(counts, global_batch_size=b,
                     method=f"lds(delta={delta},R={int(reinit)})",
                     em_iterations=int(em_total), pi_history=pi_hist)
