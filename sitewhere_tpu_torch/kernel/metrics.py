"""Lightweight metrics: counters, gauges, histograms with quantiles,
and a sliding-window meter. The hot-path cost is a plain float add: callers
hold the metric object, there is no label lookup on the fast path."""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Optional

import numpy as np


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        self.value += amount


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Fixed-bucket histogram with quantile estimation.

    Default buckets are exponential from 10µs to ~40s — wide enough for both
    per-batch scoring latency and training-step times.
    """

    __slots__ = ("name", "buckets", "counts", "count", "sum", "_max")

    def __init__(self, name: str, buckets: Optional[list[float]] = None):
        self.name = name
        if buckets is None:
            buckets = [1e-5 * (2 ** i) for i in range(22)]
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self._max = 0.0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        self.counts[i] += 1
        self.count += 1
        self.sum += value
        if value > self._max:
            self._max = value

    def observe_array(self, values) -> None:
        """Vectorized bulk observe (per-event latency can't afford a
        Python loop)."""
        values = np.asarray(values, np.float64)
        if values.size == 0:
            return
        idx = np.searchsorted(self.buckets, values, side="left")
        binned = np.bincount(idx, minlength=len(self.counts))
        for i, c in enumerate(binned):
            if c:
                self.counts[i] += int(c)
        self.count += values.size
        self.sum += float(values.sum())
        m = float(values.max())
        if m > self._max:
            self._max = m

    def quantile(self, q: float) -> float:
        """Estimate of the q-quantile: linear interpolation within the
        bucket that crosses the target rank (upper-bounded by `_max`).
        An empty histogram returns 0.0; q is clamped into [0, 1]."""
        if self.count == 0 or not math.isfinite(q):
            return 0.0
        q = min(max(q, 0.0), 1.0)
        target = max(math.ceil(q * self.count), 1)
        seen = 0
        for i, c in enumerate(self.counts):
            if c and seen + c >= target:
                hi = self.buckets[i] if i < len(self.buckets) else self._max
                lo = self.buckets[i - 1] if 0 < i <= len(self.buckets) else 0.0
                frac = (target - seen) / c
                return min(lo + frac * (hi - lo), self._max)
            seen += c
        return self._max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class Meter:
    """Events/sec over a sliding window."""

    __slots__ = ("name", "_events", "_t0", "_lock")

    def __init__(self, name: str, window_s: float = 10.0):
        self.name = name
        self._events: list[tuple[float, float]] = []  # (t, n)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()

    def mark(self, n: float = 1.0) -> None:
        with self._lock:
            self._events.append((time.monotonic(), n))
            if len(self._events) > 8192:
                self._compact()

    def _compact(self) -> None:
        cutoff = time.monotonic() - 60.0
        self._events = [e for e in self._events if e[0] >= cutoff]

    def rate(self, window_s: float = 10.0) -> float:
        now = time.monotonic()
        cutoff = now - window_s
        with self._lock:
            total = sum(n for t, n in self._events if t >= cutoff)
            earliest = min((t for t, _ in self._events if t >= cutoff), default=now)
        span = max(now - max(cutoff, min(earliest, now)), 1e-9)
        span = min(window_s, max(now - self._t0, 1e-9), span) or 1e-9
        return total / span if span > 0 else 0.0


class MetricsRegistry:
    """Named metric factory + snapshot."""

    def __init__(self, namespace: str = "swx"):
        self.namespace = namespace
        self._metrics: dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name} already registered as {type(m).__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets: Optional[list[float]] = None) -> Histogram:
        m = self._metrics.get(name)
        if m is None:
            m = Histogram(name, buckets)
            self._metrics[name] = m
        return m  # type: ignore[return-value]

    def meter(self, name: str) -> Meter:
        return self._get(name, Meter)

    def snapshot(self) -> dict:
        out: dict[str, object] = {}
        for name, m in sorted(self._metrics.items()):
            if isinstance(m, (Counter, Gauge)):
                out[name] = m.value
            elif isinstance(m, Meter):
                out[name] = {"rate_10s": m.rate(10.0), "rate_60s": m.rate(60.0)}
            elif isinstance(m, Histogram):
                out[name] = {
                    "count": m.count, "mean": m.mean,
                    "p50": m.quantile(0.50), "p95": m.quantile(0.95),
                    "p99": m.quantile(0.99),
                    "max": m._max,
                }
        return out
