"""Counter / gauge / histogram registry with streaming percentiles (numpy
copy of :mod:`repro.obs.metrics`).

Two consumers share this module:

* the serving reports — :func:`percentiles` is the one latency-summary
  helper behind ``ServeReport`` (previously duplicated ad-hoc
  ``_percentiles`` assembly in the engines), including ``p99``;
* live instrumentation — a :class:`MetricsRegistry` of named
  :class:`Counter`/:class:`Gauge`/:class:`Histogram` instruments whose
  snapshot lands in the JSONL event log. Histograms estimate quantiles
  *streamingly* with the P² algorithm (Jain & Chlamtac 1985): five
  markers per quantile, O(1) memory per observation — million-request
  traces never buffer their samples (exact below a small-sample cutoff,
  where P² has not converged yet).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np


def percentiles(xs: Iterable[float]) -> Dict[str, float]:
    """Latency-style summary of a finite sample: mean/p50/p95/p99/max.

    The one helper behind every ServeReport percentile block (exact, for
    report-time summaries of collected rows; use :class:`Histogram` when
    the sample must not be buffered).
    """
    xs = list(xs)
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0,
                "max": 0.0}
    a = np.asarray(xs, np.float64)
    return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
            "p95": float(np.percentile(a, 95)),
            "p99": float(np.percentile(a, 99)), "max": float(a.max())}


def group_percentiles(rows: Iterable[Dict], key: str,
                      fields: Iterable[str]) -> Dict[str, Dict[str, Dict]]:
    """Per-group :func:`percentiles` summaries of report-style rows.

    Groups ``rows`` (dicts) by ``row[key]`` (missing key → ``"default"``)
    and summarizes each of ``fields`` within each group — the helper
    behind ``ServeReport``'s per-tenant p50/p95/p99 TTFT/latency blocks.
    Group order in the result is sorted for deterministic JSON.
    """
    groups: Dict[str, List[Dict]] = {}
    for r in rows:
        groups.setdefault(str(r.get(key, "default")), []).append(r)
    return {g: {f: percentiles([r[f] for r in rs]) for f in fields}
            for g, rs in sorted(groups.items())}


class P2Quantile:
    """Streaming quantile estimate via the P² algorithm (O(1) memory).

    Five markers track the running min, max, target quantile, and the two
    midpoints; marker heights adjust with a piecewise-parabolic update as
    observations arrive. Exact until five samples have been seen.
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError("quantile must be in (0, 1)")
        self.q = float(q)
        self._init: List[float] = []          # first five observations
        self._n: Optional[np.ndarray] = None  # marker positions (int)
        self._np: Optional[np.ndarray] = None # desired positions (float)
        self._h: Optional[np.ndarray] = None  # marker heights
        self.count = 0

    def update(self, x: float) -> None:
        self.count += 1
        x = float(x)
        if self._h is None:
            self._init.append(x)
            if len(self._init) == 5:
                self._init.sort()
                self._h = np.asarray(self._init, np.float64)
                self._n = np.arange(5, dtype=np.float64)
                self._np = np.asarray(
                    [0.0, 2 * self.q, 4 * self.q, 2 + 2 * self.q, 4.0])
            return
        h, n = self._h, self._n
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = int(np.searchsorted(h, x, side="right")) - 1
        n[k + 1:] += 1.0
        self._np += np.asarray([0.0, self.q / 2, self.q,
                                (1 + self.q) / 2, 1.0])
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1.0 and n[i + 1] - n[i] > 1.0) \
                    or (d <= -1.0 and n[i - 1] - n[i] < -1.0):
                d = 1.0 if d > 0 else -1.0
                # piecewise-parabolic height prediction, linear fallback
                hp = h[i] + d / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + d) * (h[i + 1] - h[i])
                    / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1])
                    / (n[i] - n[i - 1]))
                if not h[i - 1] < hp < h[i + 1]:
                    j = i + int(d)
                    hp = h[i] + d * (h[j] - h[i]) / (n[j] - n[i])
                h[i] = hp
                n[i] += d

    def value(self) -> float:
        if self._h is not None:
            return float(self._h[2])
        if not self._init:
            return 0.0
        return float(np.percentile(np.asarray(self._init), self.q * 100))


class Counter:
    """Monotonic event count."""

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value plus its observed extrema."""

    def __init__(self):
        self.value = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def set(self, v: float) -> None:
        v = float(v)
        self.value = v
        self.min = min(self.min, v)
        self.max = max(self.max, v)


# Below this many observations the histogram reports exact percentiles
# from its (bounded) buffer; beyond it, the P² streaming estimates.
_EXACT_CUTOFF = 256


class Histogram:
    """Streaming distribution summary: count/sum/min/max + P² quantiles."""

    QUANTILES = (0.5, 0.95, 0.99)

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._est = {q: P2Quantile(q) for q in self.QUANTILES}
        self._exact: List[float] = []

    def observe(self, x: float) -> None:
        x = float(x)
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)
        if len(self._exact) < _EXACT_CUTOFF:
            self._exact.append(x)
        for est in self._est.values():
            est.update(x)

    def snapshot(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        out = {"count": self.count, "mean": self.sum / self.count,
               "min": self.min, "max": self.max}
        if self.count <= _EXACT_CUTOFF:
            a = np.asarray(self._exact, np.float64)
            for q in self.QUANTILES:
                out[f"p{int(q * 100)}"] = float(np.percentile(a, q * 100))
        else:
            for q, est in self._est.items():
                out[f"p{int(q * 100)}"] = est.value()
        return out


class MetricsRegistry:
    """Named instruments, lazily created, snapshot as one nested dict."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def snapshot(self) -> Dict[str, Dict]:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: {"value": g.value, "min": g.min, "max": g.max}
                       for k, g in self._gauges.items()},
            "histograms": {k: h.snapshot()
                           for k, h in self._histograms.items()},
        }
