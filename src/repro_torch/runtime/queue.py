"""Request queue + global admission control (the GPSL invariant, served;
port of :mod:`repro.runtime.queue`).

On the training side the paper's server fixes the *effective global batch*:
every optimization step consumes exactly B samples, however many clients are
connected and however late the stragglers run (PAPER.md, Sec. III/V-B). The
serving analogue implemented here fixes the *per-step decode token budget*:
the admission controller grants a request a slot only while

    active_slots × 1 token/step  ≤  token_budget

so the cost of a decode step is decided by the server, never by queue depth.
A thousand waiting clients change queueing delay, not step time — exactly
how GPSL decouples batch size from client count. Finished requests release
their slot (see repro_torch.runtime.kvcache) and the freed budget is re-granted to
the queue head, which is what turns the static batch into a continuous one.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from repro_torch.api.registry import register_admission_policy


@dataclasses.dataclass
class ServeRequest:
    """One client generation request.

    ``arrival_s`` is the time (seconds, scheduler clock) at which the prompt
    becomes visible to the server — straggler clients arrive late (their
    delays come from :func:`repro_torch.runtime.workload.assign_delays`). ``tenant`` names
    the budget-share owner under multi-tenant admission (the "tenant"
    policy); single-tenant workloads leave the default.
    """
    rid: int
    prompt: np.ndarray            # (S,) int32 token ids, unpadded
    max_new_tokens: int
    arrival_s: float = 0.0
    tenant: str = "default"

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")


class RequestQueue:
    """Arrival-ordered pending-request queue.

    ``poll(now)`` pops every request whose ``arrival_s <= now`` in arrival
    order; ``next_arrival()`` tells an idle scheduler how long it may sleep
    without missing anyone. Ties break by submission order.
    """

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, req: ServeRequest) -> None:
        heapq.heappush(self._heap, (req.arrival_s, next(self._seq), req))

    def poll(self, now: float) -> List[ServeRequest]:
        out = []
        while self._heap and self._heap[0][0] <= now:
            out.append(heapq.heappop(self._heap)[2])
        return out

    def next_arrival(self) -> Optional[float]:
        return self._heap[0][0] if self._heap else None

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


@register_admission_policy("budget")
class AdmissionController:
    """Holds the per-step decode token budget fixed at ``token_budget``.

    Pure bookkeeping — the scheduler asks ``grants(active)`` before admitting
    and reports every decode step through ``note_step(active)`` so the
    invariant (active ≤ budget at every step) is auditable after the fact via
    ``step_active``/``max_active``.

    This is the registered ``"budget"`` admission policy (the GPSL
    invariant, served); alternatives plug in via
    ``repro.api.register_admission_policy`` and one ``admission.policy``
    spec field, with the same ``grants``/``note_admit``/``note_step``
    surface.
    """

    def __init__(self, token_budget: int):
        if token_budget < 1:
            raise ValueError("token_budget must be >= 1")
        self.token_budget = int(token_budget)
        self.admitted = 0
        self.step_active: List[int] = []
        self.max_active = 0

    def grants(self, active_tokens: int) -> int:
        """How many new requests may be admitted right now."""
        return max(0, self.token_budget - int(active_tokens))

    def note_admit(self, n: int = 1) -> None:
        self.admitted += n

    def note_step(self, active_tokens: int) -> None:
        active_tokens = int(active_tokens)
        if active_tokens > self.token_budget:
            raise RuntimeError(
                f"admission invariant violated: {active_tokens} active "
                f"decode tokens > budget {self.token_budget}")
        self.step_active.append(active_tokens)
        self.max_active = max(self.max_active, active_tokens)


def apportion(total: int, weights: Mapping[str, float],
              priorities: Optional[Mapping[str, int]] = None
              ) -> Dict[str, int]:
    """Integer apportionment of ``total`` by weight (largest remainder).

    The returned shares sum *exactly* to ``total`` — this is the arithmetic
    backbone of the multi-tenant GPSL invariant: however the weights slice
    it, the global per-step token budget never changes. Ties in the
    fractional remainders break by (higher priority, name) so the result
    is deterministic.
    """
    if total < 0:
        raise ValueError("total must be >= 0")
    if not weights:
        return {}
    wsum = float(sum(weights.values()))
    if wsum <= 0:
        raise ValueError("weights must sum to a positive value")
    priorities = priorities or {}
    quotas = {t: total * (w / wsum) for t, w in weights.items()}
    shares = {t: int(q) for t, q in quotas.items()}
    left = total - sum(shares.values())
    order = sorted(weights,
                   key=lambda t: (-(quotas[t] - shares[t]),
                                  -priorities.get(t, 0), t))
    for t in order[:left]:
        shares[t] += 1
    return shares


@register_admission_policy("tenant")
class TenantAdmissionController(AdmissionController):
    """Partitions the fixed global budget into per-tenant shares.

    The global invariant is unchanged (``note_step`` still audits
    ``active <= token_budget``); on top of it, every scheduler step calls
    :meth:`step_shares` with the current per-tenant demand and receives
    integer shares that

    * sum exactly to ``token_budget`` (the GPSL invariant across tenants),
    * never exceed a tenant's demand while another tenant is starved
      (work-conserving: unused share is redistributed by weight), and
    * fall back to the nominal weight apportionment when demand is short —
      the budget is always fully assigned, never shrunk.

    ``tenants`` is a sequence of TenantSpec-likes (``name``/``share``/
    ``priority``). The scheduler preempts a tenant down to its share when
    ``preempt`` is on (over-budget requests requeue and resume
    token-identically); with preemption off, shares cap only *new*
    admissions and :meth:`note_tenant_step` records rather than raises.
    """

    def __init__(self, token_budget: int, tenants: Sequence = (),
                 preempt: bool = True):
        super().__init__(token_budget)
        if not tenants:
            raise ValueError("the tenant admission policy needs at least "
                             "one tenant (name/share/priority)")
        self.tenants = [t.name for t in tenants]
        if len(set(self.tenants)) != len(self.tenants):
            raise ValueError(f"duplicate tenant names: {self.tenants}")
        self.weights = {t.name: float(t.share) for t in tenants}
        if any(w <= 0 for w in self.weights.values()):
            raise ValueError("tenant shares must be positive")
        self.priorities = {t.name: int(t.priority) for t in tenants}
        self.preempt = bool(preempt)
        self.preemptions: Dict[str, int] = {t: 0 for t in self.tenants}
        self.share_history: List[Dict[str, int]] = []

    def step_shares(self, demand: Mapping[str, int]) -> Dict[str, int]:
        """Per-tenant integer shares for one step, given current demand.

        ``demand[t]`` is tenant ``t``'s active slots + queued requests.
        Water-filling: repeatedly apportion the unassigned budget across
        still-unsatisfied tenants by weight, capping each tenant at its
        demand; whatever remains once every demand is met is handed out
        by the nominal weights, so the shares *always* sum to the budget.
        """
        unknown = set(demand) - set(self.tenants)
        if unknown:
            raise ValueError(f"demand for undeclared tenants "
                             f"{sorted(unknown)}")
        shares = {t: 0 for t in self.tenants}
        remaining = self.token_budget
        hungry = [t for t in self.tenants if int(demand.get(t, 0)) > 0]
        while remaining > 0 and hungry:
            alloc = apportion(remaining,
                              {t: self.weights[t] for t in hungry},
                              self.priorities)
            progressed = False
            for t in hungry:
                give = min(alloc[t], int(demand.get(t, 0)) - shares[t])
                if give > 0:
                    shares[t] += give
                    remaining -= give
                    progressed = True
            hungry = [t for t in hungry
                      if shares[t] < int(demand.get(t, 0))]
            if not progressed:
                break
        if remaining > 0:
            for t, extra in apportion(remaining, self.weights,
                                      self.priorities).items():
                shares[t] += extra
        assert sum(shares.values()) == self.token_budget
        return shares

    def note_preempt(self, tenant: str, n: int = 1) -> None:
        self.preemptions[tenant] = self.preemptions.get(tenant, 0) + n

    def note_tenant_step(self, active: Mapping[str, int],
                         shares: Mapping[str, int]) -> None:
        """Audit one decode step against the per-tenant shares.

        With preemption on, a tenant above its effective share is a
        scheduler bug (the step should have preempted first) and raises;
        with preemption off, overshoot is expected to drain naturally and
        is only recorded. Either way the share vector lands in
        ``share_history`` for post-hoc audits (shares sum to the budget
        on every entry)."""
        self.share_history.append(dict(shares))
        if self.preempt:
            for t, a in active.items():
                if int(a) > int(shares.get(t, 0)):
                    raise RuntimeError(
                        f"tenant share invariant violated: {t} holds "
                        f"{a} slots > share {shares.get(t, 0)}")
