"""Counters and histograms for the sim / federated stack.

A :class:`Metrics` registry is owned by each :class:`repro_torch.obs.trace.
Tracer`; the instrumented layers bump it alongside event emission:

    bytes_air{station=g}      uplink bytes put on the air per GS link
    bytes_retx                retransmitted / truncated-attempt bytes
    bytes_down                nominal coordinator broadcast bytes
    deliveries{status=...}    delivered / lost counts
    delivery_latency          histogram of t_done − t_start (seconds)
    staleness                 histogram of aggregation staleness (async)
    lost_frac                 histogram of per-round lost fraction

Everything is plain-python (no numpy in the hot increment path) and
serializes through :meth:`Metrics.to_dict` into the trace's final JSONL
record.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

# default histogram bucket upper bounds: ~log-spaced, generous range so
# one set covers seconds-scale latencies, staleness counts, and fractions
DEFAULT_BOUNDS = (0.01, 0.1, 0.5, 1.0, 5.0, 10.0, 60.0, 300.0, 1800.0,
                  7200.0, 43200.0)

# phase-profiler bounds (repro_torch.obs.prof): per-round phase totals span
# microseconds (a window-fit pass at mega-1000) to whole-round seconds
PHASE_BOUNDS = (1e-6, 3e-6, 1e-5, 3e-5, 1e-4, 3e-4, 1e-3, 3e-3, 1e-2,
                3e-2, 0.1, 0.3, 1.0, 3.0, 10.0)


class Counter:
    """Labelled monotone counter: ``add(v, station=3)`` accumulates into
    the ``(("station", 3),)`` cell; unlabelled adds use the ``()`` cell."""

    __slots__ = ("cells",)

    def __init__(self):
        self.cells: Dict[Tuple, float] = {}

    def add(self, value: float = 1.0, **labels) -> None:
        key = tuple(sorted(labels.items()))
        self.cells[key] = self.cells.get(key, 0.0) + value

    @property
    def total(self) -> float:
        return sum(self.cells.values())

    def to_dict(self) -> dict:
        out = {"total": self.total}
        labelled = {",".join(f"{k}={v}" for k, v in key): val
                    for key, val in sorted(self.cells.items()) if key}
        if labelled:
            out["cells"] = labelled
        return out


class Histogram:
    """Fixed-bound histogram with count/sum/min/max sidecar stats.

    Out-of-range samples are never silently dropped: values above the
    last bound land in the overflow bucket (``counts[-1]``, surfaced as
    an explicit ``overflow`` count in the snapshot), and — with an
    optional lower bound ``lo`` — values below it are tallied as
    ``underflow`` instead of distorting the first bucket.  Under- and
    overflowing samples still contribute to count/sum/min/max, so the
    sidecar stats always describe every observation.
    """

    __slots__ = ("bounds", "lo", "counts", "underflow", "count", "sum",
                 "min", "max")

    def __init__(self, bounds: Optional[Sequence[float]] = None,
                 lo: Optional[float] = None):
        self.bounds = tuple(bounds) if bounds is not None else DEFAULT_BOUNDS
        self.lo = lo
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow bucket
        self.underflow = 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        if self.lo is not None and value < self.lo:
            self.underflow += 1
        else:
            i = 0
            for b in self.bounds:
                if value <= b:
                    break
                i += 1
            self.counts[i] += 1
        self.count += 1
        self.sum += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    @property
    def overflow(self) -> int:
        return self.counts[-1]

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Interpolated ``q``-th percentile (``q`` in [0, 100]) from the
        bucket counts.

        Linear interpolation inside the containing bucket, with exact
        edges everywhere a sidecar stat pins one: the underflow bucket
        spans ``[min, lo)``, the first regular bucket starts at ``lo``
        (or ``min`` without a lower bound), and the overflow bucket
        spans ``(bounds[-1], max]``.  The result is clamped to
        ``[min, max]``, so p0 → ``min`` and p100 → ``max`` hold
        regardless of bucket geometry.  Returns ``None`` when empty."""
        if not self.count:
            return None
        q = min(max(float(q), 0.0), 100.0)
        target = q / 100.0 * self.count
        buckets = []                       # (count, lower_edge, upper_edge)
        if self.underflow:
            buckets.append((self.underflow, self.min, self.lo))
        lo_edge = self.lo if self.lo is not None else self.min
        for i, b in enumerate(self.bounds):
            if self.counts[i]:
                buckets.append((self.counts[i], lo_edge, b))
            lo_edge = b
        if self.counts[-1]:
            buckets.append((self.counts[-1], self.bounds[-1], self.max))
        cum = 0
        for c, e0, e1 in buckets:
            if target <= cum + c:
                frac = (target - cum) / c
                return min(max(e0 + (e1 - e0) * frac, self.min), self.max)
            cum += c
        return self.max

    def to_dict(self) -> dict:
        return {"count": self.count, "sum": self.sum, "mean": self.mean,
                "min": self.min if self.count else None,
                "max": self.max if self.count else None,
                "bounds": list(self.bounds), "counts": list(self.counts),
                "lo": self.lo, "underflow": self.underflow,
                "overflow": self.overflow}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        """Rebuild a histogram from a :meth:`to_dict` snapshot (what a
        trace's final ``metrics`` record carries) — lets the profiler
        rollup compute percentiles from a loaded trace."""
        h = cls(d["bounds"], lo=d.get("lo"))
        h.counts = list(d["counts"])
        h.underflow = int(d.get("underflow", 0))
        h.count = int(d["count"])
        h.sum = float(d["sum"])
        h.min = d["min"] if d.get("min") is not None else math.inf
        h.max = d["max"] if d.get("max") is not None else -math.inf
        return h


class Metrics:
    """Name → Counter/Histogram registry (created on first touch)."""

    __slots__ = ("counters", "histograms")

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def histogram(self, name: str,
                  bounds: Optional[Sequence[float]] = None,
                  lo: Optional[float] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(bounds, lo=lo)
        return h

    def to_dict(self) -> dict:
        return {"counters": {k: c.to_dict()
                             for k, c in sorted(self.counters.items())},
                "histograms": {k: h.to_dict()
                               for k, h in sorted(self.histograms.items())}}
