"""Continuous-batching step loop + ServeReport (port of
:mod:`repro.runtime.engine`).

One decode step = one pass of the model over the whole slot pool: every
slot carries its own position and inactive slots ride along masked — their
output is discarded host-side and their cache is overwritten on the next
admission. Prefill runs at each request's exact prompt length (no
padding); same-length admissions share one batched prefill call and each
row's cache is copied into its pool slot. ``repro`` jit-compiles the step
and donates the cache; the port runs eagerly and writes the cache in
place.

Greedy continuous decoding is token-identical to single-request decoding
(:func:`reference_generate`) up to float near-ties: batching changes
logits only at rounding level.

Known scope limits, as in ``repro``: the encoder-decoder (audio) family
decodes at one scalar position shared by the batch and is not served
here — the static engine (:mod:`repro_torch.runtime.static`) serves it;
MoE families route per batch, so capacity dropping
can couple slots (inactive slots take capacity too) — exact equivalence
with single-request decoding needs a high ``moe_capacity_factor`` (at
least num_experts / experts_per_token leaves every expert room for every
token).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.api.registry import register_engine
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.obs.metrics import (MetricsRegistry, group_percentiles,
                                     percentiles)
from repro_torch.obs.trace import null_tracer
from repro_torch.runtime.kvcache import KVCachePool
from repro_torch.runtime.queue import ServeRequest
from repro_torch.runtime.sampling import TokenSampler


def request_rows(records: Dict[int, Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-request report rows from engine-style lifecycle records.

    Shared by the continuous engine and the static server so both
    ServeReports carry the identical field set (docs/serving.md)."""
    rows = []
    for rid in sorted(records):
        r = records[rid]
        rows.append({
            "rid": rid, "prompt_len": r["prompt_len"],
            "new_tokens": len(r["tokens"]),
            "arrival_s": round(r["arrival_s"], 6),
            "ttft_ms": (r["first_token_s"] - r["arrival_s"]) * 1e3,
            "latency_ms": (r["done_s"] - r["arrival_s"]) * 1e3,
            "tenant": r.get("tenant", "default"),
            "preemptions": r.get("preemptions", 0),
            "tokens": r["tokens"]})
    return rows


@dataclasses.dataclass
class ServeReport:
    """Per-request latency/TTFT plus aggregate throughput for one run.

    The aggregate percentile blocks (``ttft_ms``/``latency_ms``) mix every
    tenant into one population, which is the single-tenant view old
    consumers expect; multi-tenant runs additionally get a ``per_tenant``
    block (p50/p95/p99 TTFT/latency per tenant plus request/preemption
    counts) and the total ``preemptions`` counter.
    """
    engine: str
    arch: str
    wall_s: float
    num_requests: int
    prefill_tokens: int
    decode_tokens: int
    steps: int
    token_budget: Optional[int]
    max_active: int
    step_active: List[int]
    per_request: List[Dict[str, Any]]
    verified: Optional[Dict[str, Any]] = None   # token-identity audit
    # static server: the whole batch shares one post-prefill TTFT stamp
    # (no per-request admission exists there) — flagged so consumers don't
    # read its ttft percentiles as a distribution.
    ttft_shared: bool = False
    preemptions: int = 0
    tenant_shares: Optional[Dict[str, int]] = None  # last computed shares
    # KV-memory accounting (pool.cache_stats()): capacity/peak bytes,
    # utilization, fragmentation — the slot-pooled vs paged memory story
    # as a measured report field, not an assertion (docs/serving.md).
    cache_utilization: Optional[Dict[str, Any]] = None
    # streaming run only: per-token emission audit (stream order ==
    # final token order, checked in api.serving.audit_stream).
    stream: Optional[Dict[str, Any]] = None
    # speculative engine only: windows/proposed/accepted counters,
    # acceptance rate and tokens per verify step.
    speculation: Optional[Dict[str, Any]] = None

    @property
    def requests_per_s(self) -> float:
        return self.num_requests / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def decode_tok_per_s(self) -> float:
        return self.decode_tokens / self.wall_s if self.wall_s > 0 else 0.0

    def tenant_summary(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant p50/p95/p99 TTFT/latency + request/preempt counts."""
        out = group_percentiles(self.per_request, "tenant",
                                ("ttft_ms", "latency_ms"))
        for tenant, block in out.items():
            rows = [r for r in self.per_request
                    if r.get("tenant", "default") == tenant]
            block["num_requests"] = len(rows)
            block["preemptions"] = sum(r.get("preemptions", 0)
                                       for r in rows)
        return out

    def to_json(self) -> Dict[str, Any]:
        ttft = percentiles([r["ttft_ms"] for r in self.per_request])
        lat = percentiles([r["latency_ms"] for r in self.per_request])
        out = {"engine": self.engine, "arch": self.arch,
                "wall_s": round(self.wall_s, 4),
                "num_requests": self.num_requests,
                "prefill_tokens": self.prefill_tokens,
                "decode_tokens": self.decode_tokens,
                "steps": self.steps,
                "token_budget": self.token_budget,
                "max_active": self.max_active,
                "requests_per_s": round(self.requests_per_s, 2),
                "decode_tok_per_s": round(self.decode_tok_per_s, 2),
                "ttft_ms": ttft, "ttft_shared": self.ttft_shared,
                "latency_ms": lat,
                "preemptions": self.preemptions,
                "per_tenant": self.tenant_summary(),
                "per_request": self.per_request}
        if self.tenant_shares is not None:
            out["tenant_shares"] = self.tenant_shares
        if self.cache_utilization is not None:
            out["cache_utilization"] = self.cache_utilization
        if self.stream is not None:
            out["stream"] = self.stream
        if self.speculation is not None:
            out["speculation"] = self.speculation
        if self.verified is not None:
            out["verified"] = self.verified
        return out

    def summary(self) -> str:
        ttft = percentiles([r["ttft_ms"] for r in self.per_request])
        return (f"[{self.engine}] {self.num_requests} requests in "
                f"{self.wall_s:.2f}s — {self.requests_per_s:.1f} req/s, "
                f"{self.decode_tok_per_s:.1f} decode tok/s, "
                f"ttft p50/p95 {ttft['p50']:.1f}/{ttft['p95']:.1f}ms, "
                f"max_active={self.max_active}"
                + (f"/{self.token_budget}" if self.token_budget else ""))


class _SlotBudgeter:
    """Admission budget for the slot pool: one free slot per request."""

    def __init__(self, pool):
        self._free = pool.num_free

    def can_take(self, req: ServeRequest) -> bool:
        return self._free > 0

    def take(self, req: ServeRequest) -> None:
        self._free -= 1


def _resolve_now(now) -> float:
    """Timestamps are taken *after* the blocking device sync so WallClock
    TTFT/latency include the compute that produced the token; pass a
    callable (e.g. ``clock.now``) to get that, or a float to pin a time."""
    return now() if callable(now) else now


@register_engine("continuous")
class ContinuousEngine:
    """Slot-pool decode engine. The scheduler drives admit()/step().

    VLM configs are served text-only: the prompt-only prefill never feeds
    the patches pathway, as in ``repro``.

    Runs on ``device`` ("cuda" by default; raises without a card unless
    the caller passes ``device="cpu"``). Without ``params`` it initializes
    random weights from a ``torch.Generator`` seeded with ``seed`` on that
    device."""

    def __init__(self, cfg, params=None, *, num_slots: int,
                 slot_len: int, seed: int = 0, model=None, sampling=None,
                 device="cuda"):
        self._check_family(cfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = model if model is not None else build_model(cfg)
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(seed))
            params = self.model.init(gen)
        self.params = params
        self.sampler = TokenSampler(sampling)
        self.pool = self._make_pool(num_slots, slot_len)
        p = self.pool.num_slots
        self._rid = np.full(p, -1, np.int64)       # -1 = slot idle
        self._tok = np.zeros(p, np.int32)          # last emitted token
        self._remaining = np.zeros(p, np.int64)    # tokens still to emit
        self._idx = np.zeros(p, np.int32)          # next output token index
        self.metrics = MetricsRegistry()
        self.records: Dict[int, Dict[str, Any]] = {}
        self.steps = 0
        self.decode_tokens = 0
        self.prefill_tokens = 0
        # Streaming surface: every generated token funnels through
        # _emit_token, so a consumer set here observes tokens in exactly
        # the order the final report carries them.
        self.on_token = None           # callable(rid, idx, tok, t_s)
        self._tracer = null_tracer()   # rebound by serve()

    # subclass hooks ------------------------------------------------------
    @staticmethod
    def _check_family(cfg) -> None:
        if cfg.family == "audio":
            raise NotImplementedError(
                "the encoder-decoder family decodes with a scalar position "
                "(learned absolute embeddings) and is not served by the "
                "continuous runtime; use the static server")

    def _make_pool(self, num_slots: int, slot_len: int):
        return KVCachePool(self.model, num_slots, slot_len,
                           device=self.device)

    def _run_prefill(self, tokens, plen: int):
        return self.model.prefill(self.params, {"tokens": tokens},
                                  cache_len=self.pool.slot_len)

    def _device_step(self, tokens, pos, rids, idxs):
        logits, _ = self.model.decode_step(self.params, self.pool.buffers,
                                           tokens, pos)
        return self.sampler.sample(logits[:, -1], rids, idxs)

    def drain_evicted(self) -> List[ServeRequest]:
        """Resume requests for victims the *engine* evicted mid-step.

        The slot engine never self-evicts (capacity is reserved up front),
        so this is empty here; the paged engine hands back requests it
        preempted to stay inside the page pool and the scheduler requeues
        them."""
        return []

    @classmethod
    def from_spec(cls, cfg, spec, params=None, model=None,
                  device="cuda") -> "ContinuousEngine":
        """Engine sized by a ServeSpec (resolved slots/slot_len/seed);
        pass ``model`` to adopt an already-built model for ``cfg``."""
        return cls(cfg, params=params, num_slots=spec.resolved_num_slots(),
                   slot_len=spec.resolved_slot_len(), seed=spec.engine.seed,
                   model=model, sampling=getattr(spec, "sampling", None),
                   device=device)

    def serve(self, requests: List[ServeRequest], spec,
              clock=None, tracer=None) -> ServeReport:
        """One spec-driven serving run: scheduler stack from the spec's
        admission/scheduler/clock sub-specs, then drain ``requests``.

        Resets per-request bookkeeping first (params and pool survive),
        so one engine can serve warmup + timed passes back to back.
        ``tracer`` (repro_torch.obs) receives scheduler-phase and per-request
        lifecycle spans; build it on the same clock for coherent traces.
        """
        from repro_torch.runtime.scheduler import Scheduler
        if self.steps or self.records:
            self.reset()
        sched = Scheduler.from_spec(self, spec, clock=clock, tracer=tracer)
        self._tracer = sched.tracer    # per-token instants on request tracks
        return sched.run(requests)

    def reset(self) -> None:
        """Forget all requests/stats but keep params and the pool."""
        self.pool.reset()
        self._rid[:] = -1
        self._tok[:] = 0
        self._remaining[:] = 0
        self._idx[:] = 0
        self.metrics = MetricsRegistry()
        self.records = {}
        self.steps = self.decode_tokens = self.prefill_tokens = 0

    # ----- capacity -----
    def num_active(self) -> int:
        return int((self._rid >= 0).sum())

    def admission_budgeter(self):
        """Stateful per-loop admission budget the scheduler consults.

        The slot engine's budget is simply the free-slot count; the paged
        engine's additionally requires enough free *pages* for the
        candidate's prompt plus one growth page per already-active request
        (the GPSL fixed-work invariant restated in pages). ``can_take``
        must stay true after ``take`` for every admitted request in the
        same loop iteration — the budgeter tracks its own reservations.
        """
        return _SlotBudgeter(self.pool)

    def active_requests(self) -> List[Dict[str, Any]]:
        """Live (slot-holding) requests: rid, tenant, emitted count.

        The scheduler's tenant bookkeeping and preemption-victim choice
        read this instead of poking slot arrays, so alternative engines
        (and test stubs) only need to mirror this surface.
        """
        out = []
        for slot in np.flatnonzero(self._rid >= 0):
            rid = int(self._rid[slot])
            rec = self.records[rid]
            out.append({"rid": rid,
                        "tenant": rec.get("tenant", "default"),
                        "emitted": len(rec["tokens"])})
        return out

    # ----- admission (prefill) -----
    def admit_batch(self, reqs: List[ServeRequest], now) -> None:
        """Prefill ``reqs`` at exact prompt lengths and occupy slots.

        Same-length requests share one prefill call, chunked to the fixed
        ``_GROUP_SIZES`` (as in ``repro``, so batch shapes match). The
        prompt's last-position logits yield each request's first generated
        token, so TTFT is the admit time. A max_new_tokens == 1 request
        completes here and never consumes a slot or decode budget.
        """
        by_len: Dict[int, List[ServeRequest]] = {}
        for req in reqs:
            plen = int(req.prompt.shape[0])
            if plen + req.max_new_tokens > self.pool.slot_len:
                raise ValueError(
                    f"request {req.rid}: prompt {plen} + max_new "
                    f"{req.max_new_tokens} exceeds slot capacity "
                    f"{self.pool.slot_len}")
            by_len.setdefault(plen, []).append(req)
        for plen, group in by_len.items():
            i = 0
            while i < len(group):
                g = next(s for s in self._GROUP_SIZES
                         if s <= len(group) - i)
                self._admit_chunk(group[i:i + g], plen, now)
                i += g

    _GROUP_SIZES = (16, 4, 1)

    def _admit_chunk(self, chunk: List[ServeRequest], plen: int,
                     now) -> None:
        t_start = _resolve_now(now)    # prefill begins: enqueue ends here
        tokens = torch.from_numpy(
            np.stack([r.prompt for r in chunk])).to(self.device)
        logits, cache, _ = self._run_prefill(tokens, plen)
        rids = torch.as_tensor([r.rid for r in chunk], dtype=torch.int32,
                               device=self.device)
        idxs = torch.as_tensor([self._resume_index(r) for r in chunk],
                               dtype=torch.int32, device=self.device)
        firsts = self.sampler.sample(logits, rids,
                                     idxs).cpu().numpy()     # syncs
        t = _resolve_now(now)          # after the sync: TTFT covers prefill
        self.prefill_tokens += plen * len(chunk)
        for row, req in enumerate(chunk):
            first = int(firsts[row])
            rec = self.records.get(req.rid)
            if rec is not None and rec.pop("resume_pending", False):
                # Preempted request resuming: its prompt is the original
                # prompt + everything already emitted, so this prefill's
                # last-position argmax is the token an uninterrupted
                # decode would have produced next.
                self._emit_token(req.rid, first, t)
            else:
                rec = {"rid": req.rid, "prompt_len": plen,
                       "max_new_tokens": req.max_new_tokens,
                       "arrival_s": req.arrival_s,
                       "admit_start_s": t_start,
                       "admit_s": t, "first_token_s": t, "done_s": None,
                       "tenant": req.tenant, "preemptions": 0,
                       "prompt": np.asarray(req.prompt),
                       "tokens": []}
                self.records[req.rid] = rec
                self._emit_token(req.rid, first, t)
            if len(rec["tokens"]) >= rec["max_new_tokens"]:
                rec["done_s"] = t
                continue
            slot = self.pool.alloc()
            if slot is None:
                raise RuntimeError("admit() called with no free slot")
            self.pool.insert(cache, slot, plen, row=row)
            self._rid[slot] = req.rid
            self._tok[slot] = first
            self._remaining[slot] = rec["max_new_tokens"] \
                - len(rec["tokens"])
            self._idx[slot] = len(rec["tokens"])

    def _resume_index(self, req: ServeRequest) -> int:
        """0-based output index of the *next* token for this request —
        the emitted count when it is a resume_pending record, else 0."""
        rec = self.records.get(req.rid)
        if rec is not None and rec.get("resume_pending"):
            return len(rec["tokens"])
        return 0

    def _emit_token(self, rid: int, tok: int, t: float) -> None:
        """The single token-emission path: record append + stream hook.

        Prefill first-tokens, per-step decode tokens, and speculative
        bursts all land here, so the ``on_token`` consumer and the
        per-token trace instants observe exactly the order (and values)
        the final report's ``tokens`` lists carry.
        """
        rec = self.records[rid]
        idx = len(rec["tokens"])
        rec["tokens"].append(tok)
        if self.on_token is not None:
            self.on_token(rid, idx, tok, t)
        if self._tracer.enabled:
            self._tracer.instant("token", cat="request", ts_s=t, rid=rid,
                                 idx=idx, tok=tok)

    def preempt(self, rid: int) -> Dict[str, Any]:
        """Evict an in-flight request: free its KV slot, keep its record.

        The slot returns to the pool immediately (its cache needs no
        scrubbing — insertion overwrites). The record is flagged
        ``resume_pending`` so the next admission of this rid *appends* to
        the emitted tokens instead of restarting the lifecycle. Greedy
        decoding is a pure function of the context, so re-prefilling
        prompt + emitted-prefix resumes token-identically to an
        uninterrupted decode (pinned in tests/test_multitenant.py).
        Returns the record (the scheduler reads ``tokens`` to build the
        resume request).
        """
        slots = np.flatnonzero(self._rid == rid)
        if slots.size == 0:
            raise ValueError(f"request {rid} is not actively decoding")
        slot = int(slots[0])
        self._rid[slot] = -1
        self._remaining[slot] = 0
        self.pool.release(slot)
        rec = self.records[rid]
        rec["preemptions"] = rec.get("preemptions", 0) + 1
        rec["resume_pending"] = True
        return rec

    # ----- decode -----
    def step(self, now) -> List[int]:
        """One decode step over the pool; returns rids finished this step.
        ``now``: a float timestamp or a callable read after the device sync.

        Inactive slots decode token 0 at position 0 — masked padding whose
        output is dropped and whose cache is rewritten on insert.
        """
        active = self._rid >= 0
        n_active = int(active.sum())
        if n_active == 0:
            return []
        tokens = torch.from_numpy(
            np.where(active, self._tok, 0)[:, None]).to(self.device)
        pos = torch.from_numpy(np.where(active, self.pool.pos, 0)
                               .astype(np.int64)).to(self.device)
        rids = torch.from_numpy(np.where(active, self._rid, 0)
                                .astype(np.int32)).to(self.device)
        idxs = torch.from_numpy(np.where(active, self._idx, 0)
                                .astype(np.int32)).to(self.device)
        nxt = self._device_step(tokens, pos, rids,
                                idxs).cpu().numpy()            # syncs
        t = _resolve_now(now)        # after the sync: latency covers decode
        self.steps += 1
        self.decode_tokens += n_active
        finished: List[int] = []
        for slot in np.flatnonzero(active):
            rid = int(self._rid[slot])
            self._emit_token(rid, int(nxt[slot]), t)
            self._tok[slot] = nxt[slot]
            self.pool.pos[slot] += 1
            self._remaining[slot] -= 1
            self._idx[slot] += 1
            if self._remaining[slot] == 0:
                self.records[rid]["done_s"] = t
                self._rid[slot] = -1
                self.pool.release(int(slot))
                finished.append(rid)
        self._observe_cache()
        return finished

    def _observe_cache(self) -> None:
        """Per-step KV-memory gauges (kv_*_in_use, kv_fragmentation) so a
        run's peak/min land in ``metrics.snapshot()`` and, through the
        scheduler's tracer counters, in the live event log."""
        stats = self.pool.cache_stats()
        kind = stats["kind"]
        self.metrics.gauge(f"kv_{kind}s_in_use").set(
            stats[f"{kind}s_in_use"])
        self.metrics.gauge("kv_fragmentation").set(stats["fragmentation"])
        self.metrics.gauge("kv_in_use_bytes").set(stats["in_use_bytes"])

    # ----- reporting -----
    def build_report(self, engine_name: str, wall_s: float,
                     token_budget: Optional[int],
                     step_active: List[int],
                     tenant_shares: Optional[Dict[str, int]] = None
                     ) -> ServeReport:
        per_request = request_rows(self.records)
        stats = self.pool.cache_stats()
        cap = stats["capacity_bytes"]
        stats["utilization"] = (stats["peak_in_use_bytes"] / cap
                                if cap else 0.0)
        return ServeReport(
            engine=engine_name, arch=self.cfg.name, wall_s=wall_s,
            num_requests=len(per_request),
            prefill_tokens=self.prefill_tokens,
            decode_tokens=self.decode_tokens, steps=self.steps,
            token_budget=token_budget,
            max_active=max(step_active, default=0),
            step_active=step_active, per_request=per_request,
            preemptions=sum(r.get("preemptions", 0)
                            for r in self.records.values()),
            tenant_shares=tenant_shares,
            cache_utilization=stats)


def reference_generate(model, params, prompt: np.ndarray,
                       max_new_tokens: int, cache_len: int,
                       gaps: Optional[List[float]] = None,
                       tops: Optional[List[float]] = None) -> List[int]:
    """Single-request greedy decoding — the runtime's ground truth.

    Exact-length batch-1 prefill followed by one decode step per token, the
    same code path a continuous slot takes, with nothing else in the batch.
    Runs on the device the params live on. When ``gaps`` is a list, the
    top-2 logit gap of every step is appended to it (how close each greedy
    pick was to a tie); when ``tops`` is a list, the top logit of every
    step (the magnitude that sets the rounding of that gap).
    """
    device = params["client"]["embed"].device
    tokens = torch.as_tensor(np.asarray(prompt)[None], device=device)
    logits, cache, pos = model.prefill(params, {"tokens": tokens},
                                       cache_len=cache_len)
    toks: List[int] = []
    posv = torch.tensor([pos], device=device)
    for i in range(max_new_tokens):
        row = logits.reshape(-1)
        if gaps is not None or tops is not None:
            top2 = torch.topk(row, 2).values
            if gaps is not None:
                gaps.append(float(top2[0] - top2[1]))
            if tops is not None:
                tops.append(float(top2[0]))
        toks.append(int(torch.argmax(row)))
        if i == max_new_tokens - 1:
            break
        tok = torch.tensor([[toks[-1]]], device=device)
        logits, cache = model.decode_step(params, cache, tok, posv)
        posv = posv + 1
    return toks
