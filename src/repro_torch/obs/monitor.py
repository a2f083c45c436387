"""Live GPSL invariant monitors over streamed epoch-plan segments (numpy
copy of :mod:`repro.obs.monitor`: the same plan gives the same summary).

The paper's claim is an *invariant*: every global batch a GPSL plan
composes is distributionally equivalent to a centralized uniform
without-replacement batch, with Serfling-type deviation guarantees
(``repro_torch.core.deviation``). The repo proves this post-hoc in
tests and benches; this module makes it *continuously observable* — the
training loop feeds each step's plan segment to a :class:`GPSLMonitor`
as the step runs, and violations land in the run record and the JSONL
event log instead of waiting for an offline fig6 sweep.

Three invariants are tracked per step, all streamed from
``plan.step_segments(t)`` (never the dense (T, K) matrix, so the monitor
scales to million-client sparse plans):

* **class-proportion deviation** — the expected class composition of the
  step's global batch under local uniform without-replacement draws
  (the conditional mean of the multivariate hypergeometric per client,
  depletion carried across steps) must stay within the Serfling radius
  ``serfling_epsilon(B, D, delta)`` of the overall distribution β₀ in
  every class;
* **effective-batch-size fixedness** — every non-final step must draw
  exactly ``global_batch_size`` samples (the fixed-global-batch
  invariant; the final ragged step may be smaller but not empty);
* **data depletion** — requested draws never exceed a client's remaining
  mass (over-draw), and a *complete* epoch leaves no residual mass
  behind. A truncated run (``execution.max_steps`` stopping short of the
  plan's steps) still reports its residual but does not flag it — data
  legitimately remains when the epoch was cut off.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.core.deviation import serfling_epsilon


@dataclasses.dataclass
class MonitorSummary:
    """One epoch's verdict: counts per invariant plus the worst step."""
    epoch: int
    steps: int
    global_batch_size: int
    delta: float
    epsilon: float
    deviation_violations: int
    batch_size_violations: int
    overdraw_violations: int
    residual_mass: int
    max_class_deviation: float
    worst_step: int
    complete: bool

    @property
    def ok(self) -> bool:
        return (self.deviation_violations == 0
                and self.batch_size_violations == 0
                and self.overdraw_violations == 0
                and (self.residual_mass == 0 or not self.complete))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["ok"] = self.ok
        return d


class GPSLMonitor:
    """Streams one epoch's plan segments and checks the GPSL invariants.

    Built per epoch (depletion state is per epoch). ``observe_step`` takes
    the step's ``(client_ids, draw_counts)`` segment; :meth:`finish`
    returns the :class:`MonitorSummary`. A ``tracer`` receives one
    ``monitor`` record per step plus the summary, so violations are
    inspectable in the event log next to the spans of the steps that
    caused them.

    The deviation check compares the **expected** batch composition given
    the plan — β of each active client's remaining pool, weighted by its
    draw count — against β₀, per class, with the per-step radius
    ``serfling_epsilon(b_t, total, delta / num_steps)`` (Bonferroni over
    the epoch's steps, so the whole-epoch false-alarm mass stays ≤ δ; the
    final ragged step gets the wider radius its smaller b_t implies). The
    paper's exchangeability claim is exactly that each GPSL global batch
    is marginally a uniform without-replacement B-sample of the full
    dataset, so an honest plan stays inside the radius; a skewed plan
    (e.g. one class-imbalanced client supplying a whole step) exceeds it
    immediately. Monitoring expected composition keeps the monitor
    deterministic and independent of the actual sample draws, so
    instrumentation can never perturb training RNG.
    """

    def __init__(self, pop, global_batch_size: int, delta: float = 0.05,
                 epoch: int = 0, num_steps: Optional[int] = None,
                 tracer=None):
        self.pop = pop
        self.global_batch_size = int(global_batch_size)
        self.delta = float(delta)
        self.epoch = int(epoch)
        self.num_steps = int(num_steps) if num_steps else None
        self.tracer = tracer
        self.beta0 = pop.overall_distribution                  # (M,)
        self.remaining = pop.class_counts.astype(np.float64).copy()
        self.total = int(pop.total_size)
        self._delta_step = (self.delta / max(int(num_steps), 1)
                            if num_steps else self.delta)
        self.epsilon = serfling_epsilon(self.global_batch_size, self.total,
                                        self._delta_step)
        self.steps = 0
        self.deviation_violations = 0
        self.batch_size_violations = 0
        self.overdraw_violations = 0
        self.max_class_deviation = 0.0
        self.worst_step = -1
        self.step_records: List[Dict[str, Any]] = []
        self._finished = False

    def observe_step(self, t: int, client_ids, draw_counts,
                     final: bool = False) -> Dict[str, Any]:
        """Check step ``t``'s segment; returns (and logs) its record."""
        ids = np.asarray(client_ids, np.int64)
        cnts = np.asarray(draw_counts, np.float64)
        b = float(cnts.sum())
        rem = self.remaining[ids]                              # (A, M)
        avail = rem.sum(axis=1)
        overdraw = int(np.count_nonzero(cnts > avail + 1e-9))
        # conditional mean of the per-client multivariate hypergeometric:
        # drawing n of a client's remaining pool takes n·rem/|rem| per class
        take = np.minimum(cnts, avail)
        exp_draw = rem * np.divide(take, np.maximum(avail, 1.0))[:, None]
        exp_counts = exp_draw.sum(axis=0)                      # (M,)
        self.remaining[ids] = rem - exp_draw
        class_dev = np.abs(exp_counts / max(b, 1.0) - self.beta0)
        max_dev = float(class_dev.max()) if class_dev.size else 0.0
        l1_dev = float(class_dev.sum())
        eps_t = (self.epsilon if b >= self.global_batch_size
                 else serfling_epsilon(max(int(b), 1), self.total,
                                       self._delta_step))
        deviation_ok = max_dev <= eps_t
        batch_fixed = (0.0 < b <= self.global_batch_size if final
                       else b == self.global_batch_size)
        self.steps += 1
        if not deviation_ok:
            self.deviation_violations += 1
        if not batch_fixed:
            self.batch_size_violations += 1
        self.overdraw_violations += overdraw
        if max_dev > self.max_class_deviation:
            self.max_class_deviation = max_dev
            self.worst_step = int(t)
        rec = {"epoch": self.epoch, "step": int(t), "batch": int(b),
               "active_clients": int(ids.size),
               "max_class_deviation": max_dev, "l1_deviation": l1_dev,
               "epsilon": eps_t, "deviation_ok": deviation_ok,
               "batch_fixed": bool(batch_fixed), "overdraw": overdraw}
        self.step_records.append(rec)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.record("monitor", **rec)
        return rec

    def observe_plan_step(self, plan, t: int) -> Dict[str, Any]:
        """Convenience: stream step ``t`` straight off a plan object."""
        ids, cnts = plan.step_segments(t)
        return self.observe_step(t, ids, cnts,
                                 final=(t == plan.num_steps - 1))

    def finish(self) -> MonitorSummary:
        """Close the epoch: residual-mass check plus the summary record.

        Residual mass only counts as a violation when the monitor saw the
        plan's full step count — a run truncated by ``max_steps``
        legitimately leaves data undrawn.
        """
        residual = int(round(float(self.remaining.sum())))
        complete = self.num_steps is None or self.steps >= self.num_steps
        summary = MonitorSummary(
            epoch=self.epoch, steps=self.steps,
            global_batch_size=self.global_batch_size, delta=self.delta,
            epsilon=self.epsilon,
            deviation_violations=self.deviation_violations,
            batch_size_violations=self.batch_size_violations,
            overdraw_violations=self.overdraw_violations,
            residual_mass=residual,
            max_class_deviation=self.max_class_deviation,
            worst_step=self.worst_step, complete=complete)
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.record("monitor_summary", **summary.to_dict())
        self._finished = True
        return summary


def monitor_from_spec(obs_spec, pop, global_batch_size: int,
                      epoch: int = 0, num_steps: Optional[int] = None,
                      tracer=None) -> Optional[GPSLMonitor]:
    """GPSLMonitor for an ``ObsSpec`` (None when disabled / unmonitored)."""
    if obs_spec is None or not obs_spec.enabled or not obs_spec.monitor \
            or pop is None:
        return None
    return GPSLMonitor(pop, global_batch_size, delta=obs_spec.monitor_delta,
                       epoch=epoch, num_steps=num_steps, tracer=tracer)
