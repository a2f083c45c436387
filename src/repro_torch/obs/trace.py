"""Nested timed spans with Chrome-trace / Perfetto export and a JSONL log
(copy of :mod:`repro.obs.trace`; its JAX profiler hook becomes
:func:`maybe_profiler` over ``torch.profiler``).

A :class:`Tracer` records three shapes of telemetry:

* **spans** — timed intervals (``with tracer.span("plan"): ...``), nested
  lexically; also retroactive via :meth:`Tracer.complete` when the
  endpoints were stamped elsewhere (e.g. request lifecycles reconstructed
  from engine records).
* **instants / counters** — point events and sampled values (queue depth,
  active decode slots).
* **records** — structured payloads (GPSL monitor verdicts) that only
  appear in the JSONL log, not the Chrome timeline.

Timestamps come from a pluggable ``clock`` callable returning seconds —
``time.perf_counter`` by default, or a serving ``VirtualClock.now`` so a
simulated trace is a deterministic function of the spec. Export targets:

* :meth:`Tracer.chrome_trace` / :meth:`write_chrome` — the Chrome
  trace-event JSON format (load in Perfetto via *Open trace file*, or
  ``chrome://tracing``). Spans are ``"ph": "X"`` complete events; request
  lifecycles are async ``"b"``/``"e"`` pairs keyed by rid.
* :meth:`Tracer.jsonl_records` / :meth:`write_jsonl` — one JSON object per
  line: ``{"kind": "span" | "instant" | "counter" | "record", ...}`` with
  seconds-domain timestamps, the machine-readable twin the monitors and
  ``tools/trace_report.py`` consume.

Disabled runs use the :class:`NullTracer`: every method is a no-op and
``span`` returns one shared reusable context manager, so the instrumented
code paths cost one attribute lookup and an empty ``with`` block.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import time
from typing import Any, Callable, Dict, List, Optional

_US = 1e6                  # chrome trace events use microsecond timestamps


class _NullSpan:
    """Reusable no-op context manager (the disabled-tracer fast path)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Tracer with every operation a no-op; ``enabled`` is False.

    Instrumented code never branches on configuration — it always calls
    the tracer — so the disabled path must be near-free: ``span`` hands
    back one shared context manager and records nothing.
    """

    enabled = False

    def now(self) -> float:
        return 0.0

    def span(self, name: str, cat: str = "phase", **args):
        return _NULL_SPAN

    def complete(self, name: str, t0_s: float, t1_s: float,
                 cat: str = "phase", tid: int = 0, **args) -> None:
        pass

    def instant(self, name: str, cat: str = "phase", ts_s=None,
                **args) -> None:
        pass

    def counter(self, name: str, value: float, ts_s=None) -> None:
        pass

    def record(self, kind: str, **payload) -> None:
        pass

    def request_lifecycle(self, rid: int, arrival_s: float,
                          admit_start_s: float, admit_s: float,
                          done_s: float, **args) -> None:
        pass


_NULL_TRACER = NullTracer()


def null_tracer() -> NullTracer:
    """The shared disabled tracer (stateless, safe to reuse everywhere)."""
    return _NULL_TRACER


class _SpanCM:
    """Context manager produced by :meth:`Tracer.span`."""

    __slots__ = ("tracer", "name", "cat", "tid", "args", "_t0")

    def __init__(self, tracer, name, cat, tid, args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args

    def __enter__(self):
        self._t0 = self.tracer.now()
        return self

    def __exit__(self, *exc):
        self.tracer.complete(self.name, self._t0, self.tracer.now(),
                             cat=self.cat, tid=self.tid, **self.args)
        return False


class Tracer:
    """Span/instant/counter/record collector on a pluggable clock.

    ``clock`` is any zero-argument callable returning seconds (monotonic
    within one run): ``time.perf_counter`` (default), a scheduler
    ``WallClock.now``, or a ``VirtualClock.now`` for deterministic
    simulated traces. ``meta`` is attached to both export formats.
    """

    enabled = True

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self._clock = clock if clock is not None else time.perf_counter
        self.meta: Dict[str, Any] = dict(meta or {})
        self.events: List[Dict[str, Any]] = []    # chrome trace events
        self.records: List[Dict[str, Any]] = []   # JSONL-only records

    def now(self) -> float:
        return float(self._clock())

    # ----- spans ------------------------------------------------------
    def span(self, name: str, cat: str = "phase", tid: int = 0,
             **args) -> _SpanCM:
        """Timed interval context manager; nests lexically."""
        return _SpanCM(self, name, cat, tid, args)

    def complete(self, name: str, t0_s: float, t1_s: float,
                 cat: str = "phase", tid: int = 0, **args) -> None:
        """Record an already-timed interval (chrome ``"X"`` event)."""
        ev = {"ph": "X", "name": name, "cat": cat, "pid": 0, "tid": tid,
              "ts": t0_s * _US, "dur": max(t1_s - t0_s, 0.0) * _US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    # ----- points -----------------------------------------------------
    def instant(self, name: str, cat: str = "phase", ts_s=None,
                **args) -> None:
        ev = {"ph": "i", "name": name, "cat": cat, "pid": 0, "tid": 0,
              "s": "p",
              "ts": (self.now() if ts_s is None else ts_s) * _US}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def counter(self, name: str, value: float, ts_s=None) -> None:
        self.events.append(
            {"ph": "C", "name": name, "cat": "counter", "pid": 0, "tid": 0,
             "ts": (self.now() if ts_s is None else ts_s) * _US,
             "args": {"value": float(value)}})

    def record(self, kind: str, **payload) -> None:
        """Structured JSONL-only record (monitor verdicts, run metadata)."""
        self.records.append({"kind": kind, **payload})

    # ----- request lifecycles -----------------------------------------
    def request_lifecycle(self, rid: int, arrival_s: float,
                          admit_start_s: float, admit_s: float,
                          done_s: float, **args) -> None:
        """One request's enqueue→admit→prefill→decode→complete track.

        Emitted as chrome async events keyed by rid so each request gets
        its own row in Perfetto: an outer ``request`` span (arrival →
        completion) with ``enqueue`` (queued), ``prefill`` (admission
        batch prefill up to the first token), and ``decode`` phases, plus
        a ``complete`` instant. Times come from the engine's per-request
        records, already stamped in the scheduler-clock domain.
        """
        aid = str(rid)
        phases = [("request", arrival_s, done_s, args),
                  ("enqueue", arrival_s, admit_start_s, {}),
                  ("prefill", admit_start_s, admit_s, {}),
                  ("decode", admit_s, done_s, {})]
        for name, t0, t1, extra in phases:
            b = {"ph": "b", "name": name, "cat": "request", "id": aid,
                 "pid": 0, "tid": 0, "ts": t0 * _US}
            if extra:
                b["args"] = dict(extra)
            self.events.append(b)
            self.events.append({"ph": "e", "name": name, "cat": "request",
                                "id": aid, "pid": 0, "tid": 0,
                                "ts": max(t1, t0) * _US})
        self.instant("complete", cat="request", ts_s=done_s, rid=rid)

    # ----- export -----------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON document (Perfetto-loadable)."""
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms",
                "otherData": dict(self.meta)}

    def write_chrome(self, path) -> None:
        pathlib.Path(path).write_text(
            json.dumps(self.chrome_trace()) + "\n")

    def jsonl_records(self) -> List[Dict[str, Any]]:
        """Seconds-domain structured log: meta line, records, then events."""
        _KIND = {"X": "span", "i": "instant", "C": "counter",
                 "b": "async_begin", "e": "async_end"}
        out: List[Dict[str, Any]] = [{"kind": "meta",
                                      "meta": dict(self.meta)}]
        out.extend(self.records)
        for ev in self.events:
            row: Dict[str, Any] = {"kind": _KIND.get(ev["ph"], ev["ph"]),
                                   "name": ev["name"], "cat": ev["cat"],
                                   "ts_s": ev["ts"] / _US}
            if ev["ph"] == "X":
                row["dur_s"] = ev["dur"] / _US
            if "id" in ev:
                row["id"] = ev["id"]
            if "args" in ev:
                row["args"] = ev["args"]
            out.append(row)
        return out

    def write_jsonl(self, path) -> None:
        lines = [json.dumps(r) for r in self.jsonl_records()]
        pathlib.Path(path).write_text("\n".join(lines) + "\n")


def tracer_from_spec(obs_spec, clock: Optional[Callable[[], float]] = None,
                     meta: Optional[Dict[str, Any]] = None):
    """Tracer for an ``ObsSpec`` (None / disabled → the shared NullTracer)."""
    if obs_spec is None or not obs_spec.enabled:
        return _NULL_TRACER
    return Tracer(clock=clock, meta=meta)


def write_outputs(tracer, obs_spec) -> None:
    """Write the spec's configured trace artifacts (no-op when disabled)."""
    if obs_spec is None or not getattr(tracer, "enabled", False):
        return
    if obs_spec.trace_path:
        tracer.write_chrome(obs_spec.trace_path)
    if obs_spec.events_path:
        tracer.write_jsonl(obs_spec.events_path)


@contextlib.contextmanager
def maybe_profiler(obs_spec, device=None):
    """Opt-in ``torch.profiler`` trace around a run (the port of
    ``repro.obs.maybe_jax_profiler``; the spec field keeps ``repro``'s
    name, ``jax_profiler_dir``).

    Active only when the spec is enabled *and* names a profiler
    directory: it records host operators, and the card's kernels when
    ``device`` is a CUDA device, and writes one Chrome trace JSON into
    that directory when the run ends. The profiler only observes, so a
    profiled run computes what an unprofiled one does.
    """
    if obs_spec is None or not obs_spec.enabled \
            or not obs_spec.jax_profiler_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device is not None and str(device).startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(obs_spec.jax_profiler_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(
        out / f"torch_profile.{os.getpid()}.{time.time_ns()}.trace.json"))
