"""Interleaved prefill/decode scheduling with straggler-aware arrivals
(port of :mod:`repro.runtime.scheduler`; pure host logic, copied).

The loop alternates admission (prefill into freed slots, up to the token
budget) with decode steps over the pool; the admission *order* is a
registered scheduler policy (``"fifo"`` admits by arrival, ``"ljf"``
longest-job-first for tail occupancy — add more via
``repro_torch.api.register_scheduler_policy``). Straggler handling mirrors the
paper's serving lesson: a decode step **never waits** for a request that has
not arrived — the deadline for joining a step is "be in the queue when the
step starts". Late prompts (delays drawn from
repro_torch.runtime.workload.straggler_arrivals, the same delay model the
training simulator uses) therefore cost only their own TTFT, not everyone else's step
time; the static server by contrast cannot start until its whole batch is
assembled.

Clocks are pluggable: ``WallClock`` serves real time (idle waits sleep until
the next arrival); ``VirtualClock`` advances a deterministic tick per engine
operation so tests can replay randomized arrival/completion traces instantly.

``Scheduler.from_spec`` builds the whole stack — clock, admission
controller, and ordering policy resolved through the registries — from a
declarative ``ServeSpec`` (repro_torch.api.specs); hand construction stays
available for programmatic use.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.api.registry import (get_admission_policy,
                                      get_scheduler_policy,
                                      register_scheduler_policy)
from repro_torch.obs.trace import null_tracer
from repro_torch.runtime.engine import ContinuousEngine, ServeReport
from repro_torch.runtime.queue import RequestQueue, ServeRequest


@register_scheduler_policy("fifo")
class FifoPolicy:
    """Arrival-fair admission: grant freed budget to the oldest prompt."""

    def order(self, ready: List[ServeRequest]) -> None:
        pass                        # the queue already yields arrival order


@register_scheduler_policy("ljf")
class LongestJobFirstPolicy:
    """Longest-job-first keeps tail occupancy high: big completions start
    early and short ones backfill, so makespan tracks the longest request,
    not FIFO luck."""

    def order(self, ready: List[ServeRequest]) -> None:
        ready.sort(key=lambda r: -r.max_new_tokens)


class WallClock:
    """Real time, relative to construction; idle waits actually sleep."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)

    def advance(self) -> None:     # real time advances itself
        pass


class VirtualClock:
    """Deterministic simulated time: one fixed tick per engine operation."""

    def __init__(self, tick_s: float = 1e-3):
        self.tick_s = tick_s
        self._t = 0.0

    def now(self) -> float:
        return self._t

    def wait_until(self, t: float) -> None:
        self._t = max(self._t, t)

    def advance(self) -> None:
        self._t += self.tick_s


def make_clock(kind: str = "wall", tick_s: float = 1e-3):
    """Clock instance for a ClockSpec (``"wall"`` or ``"virtual"``)."""
    if kind == "wall":
        return WallClock()
    if kind == "virtual":
        return VirtualClock(tick_s)
    raise ValueError(f"unknown clock kind {kind!r}")


class Scheduler:
    """Drives a ContinuousEngine from a RequestQueue under a fixed budget.

    With a tenant-aware admission controller (``admission="tenant"`` plus
    ``tenants=[...]``), every iteration additionally (1) recomputes the
    per-tenant integer shares of the fixed global budget from current
    demand (work-conserving water-fill; shares always sum to the budget),
    (2) preempts tenants above their effective share — the evicted
    request's KV slot returns to the pool and the request requeues to
    resume from its emitted prefix, token-identically — and (3) admits in
    priority-then-policy order, capping each tenant at its share.
    """

    def __init__(self, engine: ContinuousEngine,
                 token_budget: Optional[int] = None, clock=None,
                 max_admits_per_step: Optional[int] = None,
                 policy: str = "fifo", admission: str = "budget",
                 tracer=None, tenants: Optional[Sequence] = None,
                 preempt: bool = True):
        self.tracer = tracer if tracer is not None else null_tracer()
        self.policy = policy
        self._policy = get_scheduler_policy(policy)()
        self.engine = engine
        budget = (token_budget if token_budget is not None
                  else engine.pool.num_slots)
        if budget > engine.pool.num_slots:
            raise ValueError(
                f"token budget {budget} exceeds pool capacity "
                f"{engine.pool.num_slots}: budgeted slots must exist")
        adm_cls = get_admission_policy(admission)
        if tenants:
            self.admission = adm_cls(budget, tenants=tenants,
                                     preempt=preempt)
        else:
            self.admission = adm_cls(budget)
        self._tenant_aware = hasattr(self.admission, "step_shares")
        self._prio: Dict[str, int] = getattr(self.admission, "priorities",
                                             {})
        self._origin: Dict[int, ServeRequest] = {}
        self._last_shares: Optional[Dict[str, int]] = None
        self.queue = RequestQueue()
        self.clock = clock if clock is not None else WallClock()
        if max_admits_per_step is not None and max_admits_per_step < 1:
            raise ValueError("max_admits_per_step must be >= 1 (or None)")
        self.max_admits_per_step = max_admits_per_step

    @classmethod
    def from_spec(cls, engine: ContinuousEngine, spec,
                  clock=None, tracer=None) -> "Scheduler":
        """Build the scheduling stack a ServeSpec describes around ``engine``.

        Policies resolve through the registries
        (``spec.scheduler.policy`` / ``spec.admission.policy``); the clock
        comes from ``spec.clock`` unless one is passed explicitly. A
        ``tracer`` (repro_torch.obs) built on the same clock receives phase spans
        (admit/decode_step/wait) and per-request lifecycle spans.
        ``spec.admission.tenants`` (with the "tenant" policy) turns on
        multi-tenant shares and preemption.
        """
        if clock is None:
            clock = make_clock(spec.clock.kind, spec.clock.tick_s)
        return cls(engine,
                   token_budget=spec.admission.token_budget,
                   clock=clock,
                   max_admits_per_step=spec.admission.max_admits_per_step,
                   policy=spec.scheduler.policy,
                   admission=spec.admission.policy,
                   tracer=tracer,
                   tenants=spec.admission.tenants,
                   preempt=spec.admission.preempt)

    def submit(self, requests: Sequence[ServeRequest]) -> None:
        for r in requests:
            if self._tenant_aware:
                if r.tenant not in self._prio:
                    raise ValueError(
                        f"request {r.rid}: tenant {r.tenant!r} not "
                        f"declared; known: {sorted(self._prio)}")
                self._origin[r.rid] = r
            self.queue.push(r)

    # ----- multi-tenant helpers -------------------------------------

    def _order(self, ready: List[ServeRequest]) -> None:
        """Policy order, then (stable) higher-priority tenants first."""
        self._policy.order(ready)
        if self._tenant_aware:
            ready.sort(key=lambda r: -self._prio.get(r.tenant, 0))

    def _active_by_tenant(self) -> Dict[str, int]:
        out = {t: 0 for t in self._prio}
        for a in self.engine.active_requests():
            out[a["tenant"]] += 1
        return out

    def _make_resume(self, rid: int) -> ServeRequest:
        """Evict ``rid`` and build the request that resumes it.

        The resume prompt is original-prompt + emitted-prefix (so the
        re-prefill's last-position argmax is the next uninterrupted
        token); the remaining output allowance shrinks by what was
        already emitted, so prompt+max_new still fits the slot.
        """
        orig = self._origin[rid]
        rec = self.engine.preempt(rid)
        emitted = rec["tokens"]
        return ServeRequest(
            rid=rid,
            prompt=np.concatenate([orig.prompt,
                                   np.asarray(emitted, np.int32)]),
            max_new_tokens=orig.max_new_tokens - len(emitted),
            arrival_s=self.clock.now(), tenant=orig.tenant)

    def _preempt_phase(self, ready: List[ServeRequest],
                       active_ct: Dict[str, int],
                       shares: Dict[str, int]) -> None:
        """Bring every tenant down to its effective share.

        Victims are chosen lowest-priority tenant first; within a tenant,
        the request with the least emitted tokens goes first (cheapest
        resume prefill), ties to the newest rid — fully deterministic.
        Evicted requests are appended to ``ready`` and re-ordered.
        """
        adm, tracer = self.admission, self.tracer
        over = [t for t in self._prio
                if active_ct.get(t, 0) > shares.get(t, 0)]
        if not over:
            return
        live: Dict[str, List[Dict]] = {t: [] for t in over}
        for a in self.engine.active_requests():
            if a["tenant"] in live:
                live[a["tenant"]].append(a)
        for t in sorted(over, key=lambda t: (self._prio.get(t, 0), t)):
            excess = active_ct[t] - shares.get(t, 0)
            victims = [a["rid"] for a in sorted(
                live[t], key=lambda a: (a["emitted"], -a["rid"]))]
            for rid in victims[:excess]:
                resume = self._make_resume(rid)
                adm.note_preempt(t)
                if tracer.enabled:
                    tracer.instant("preempt", cat="preempt", rid=rid,
                                   tenant=t,
                                   emitted=len(resume.prompt)
                                   - len(self._origin[rid].prompt))
                ready.append(resume)
                active_ct[t] -= 1
        self._order(ready)

    def _select_admits(self, ready: List[ServeRequest],
                       active_ct: Dict[str, int],
                       shares: Dict[str, int]) -> List[ServeRequest]:
        """Pick the admissible prefix-by-order of ``ready`` (in place).

        A request is admissible while the global headroom, the pool free
        list, and its tenant's share all have room; skipped requests keep
        their order for the next iteration.
        """
        eng, adm = self.engine, self.admission
        admits = adm.grants(eng.num_active())
        if self.max_admits_per_step is not None:
            admits = min(admits, self.max_admits_per_step)
        budget = eng.admission_budgeter()
        selected: List[ServeRequest] = []
        rest: List[ServeRequest] = []
        for r in ready:
            if admits > 0 and budget.can_take(r) \
                    and active_ct[r.tenant] < shares.get(r.tenant, 0):
                budget.take(r)
                selected.append(r)
                active_ct[r.tenant] += 1
                admits -= 1
            else:
                rest.append(r)
        ready[:] = rest
        return selected

    # ----- the serving loop ------------------------------------------

    def run(self, requests: Optional[Sequence[ServeRequest]] = None
            ) -> ServeReport:
        """Serve until the queue drains and every slot retires."""
        if requests is not None:
            self.submit(requests)
        eng, adm, clock = self.engine, self.admission, self.clock
        tracer = self.tracer
        ready: List[ServeRequest] = []
        wall0 = time.perf_counter()
        while True:
            arrived = self.queue.poll(clock.now())
            if arrived:
                ready.extend(arrived)
                self._order(ready)
            if self._tenant_aware:
                # Shares from current demand; preempt down to share, then
                # admit up to share — both in the same iteration, so freed
                # budget moves to its new owner before the next decode.
                active_ct = self._active_by_tenant()
                demand = dict(active_ct)
                for r in ready:
                    demand[r.tenant] = demand.get(r.tenant, 0) + 1
                shares = adm.step_shares(demand)
                self._last_shares = shares
                if adm.preempt:
                    self._preempt_phase(ready, active_ct, shares)
                selected = self._select_admits(ready, active_ct, shares)
                if selected:
                    with tracer.span("admit", cat="prefill",
                                     n=len(selected)):
                        eng.admit_batch(selected, clock.now)
                    adm.note_admit(len(selected))
                    clock.advance()
            else:
                # Admission: grant freed budget in policy order; same-
                # length requests in a grant share a prefill call. The
                # engine's budgeter owns the capacity arithmetic (free
                # slots for the slot pool, prompt pages + growth headroom
                # for the paged pool); skipped requests keep their order.
                admits = adm.grants(eng.num_active())
                if self.max_admits_per_step is not None:
                    admits = min(admits, self.max_admits_per_step)
                budget = eng.admission_budgeter()
                selected: List[ServeRequest] = []
                rest: List[ServeRequest] = []
                for r in ready:
                    if len(selected) < admits and budget.can_take(r):
                        budget.take(r)
                        selected.append(r)
                    else:
                        rest.append(r)
                ready[:] = rest
                if selected:
                    # clock.now passed as a callable: the engine stamps
                    # TTFT after the prefill sync, so it includes the
                    # compute.
                    with tracer.span("admit", cat="prefill",
                                     n=len(selected)):
                        eng.admit_batch(selected, clock.now)
                    adm.note_admit(len(selected))
                    clock.advance()
            if eng.num_active() > 0:
                adm.note_step(eng.num_active())
                if self._tenant_aware:
                    adm.note_tenant_step(self._active_by_tenant(),
                                         self._last_shares)
                with tracer.span("decode_step", cat="decode",
                                 active=eng.num_active()):
                    eng.step(clock.now)
                clock.advance()
                # Requests the engine itself evicted mid-step (the paged
                # engine's out-of-pages valve) requeue exactly like a
                # tenant preemption: back into ready, policy-ordered.
                evicted = eng.drain_evicted()
                if evicted:
                    ready.extend(evicted)
                    self._order(ready)
                if tracer.enabled:
                    tracer.counter("active_slots", eng.num_active())
                    tracer.counter("queued", len(ready) + len(self.queue))
                    stats = eng.pool.cache_stats()
                    kind = stats["kind"]
                    tracer.counter(f"kv_{kind}s_in_use",
                                   stats[f"{kind}s_in_use"])
                    tracer.counter("kv_fragmentation",
                                   stats["fragmentation"])
            elif ready:
                # budget exhausted with an empty pool cannot happen
                # (budget ≥ 1); loop back to admit.
                continue
            elif self.queue:
                # idle until the next straggler's prompt arrives — waiting
                # costs nothing because no admitted request is stalled.
                with tracer.span("wait", cat="idle"):
                    self.queue_wait()
            else:
                break
        wall = time.perf_counter() - wall0
        if tracer.enabled:
            for rid in sorted(eng.records):
                r = eng.records[rid]
                tracer.request_lifecycle(
                    rid, r["arrival_s"],
                    r.get("admit_start_s", r["admit_s"]), r["admit_s"],
                    r["done_s"], prompt_len=r["prompt_len"],
                    new_tokens=len(r["tokens"]))
            if self._tenant_aware:
                for t, n in adm.preemptions.items():
                    tracer.counter(f"preemptions.{t}", n)
        return eng.build_report(getattr(eng, "name", "continuous"), wall,
                                adm.token_budget, adm.step_active,
                                tenant_shares=self._last_shares)

    def queue_wait(self) -> None:
        nxt = self.queue.next_arrival()
        if nxt is not None:
            self.clock.wait_until(nxt)
