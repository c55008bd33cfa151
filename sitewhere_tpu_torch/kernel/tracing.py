"""Per-event pipeline tracing [SURVEY.md §5.1] — the trace spine of the
pipeline flight recorder.

The reference has no distributed tracing in core (logging only); the
rebuild carries a trace context in every batch envelope
(`BatchContext.trace_id`, stamped at the receiver) and records one SPAN
per pipeline stage into bounded per-stage rings:

    receiver → decode → enrich → persist → dispatch → score → egress.publish

plus the off-ramp stages (deferred spool/replay, DLQ quarantine/replay).
The stage inventory lives in `analysis/registry.py` (`TRACE_STAGES`) —
swxlint TRC01 resolves every recorded stage literal against it, exactly
as MET01 does for metric names — and each stage is classified as
*queue* (time spent waiting: receiver arrival → decode, admission →
dispatch) or *service* (time spent working), so the critical-path
report can answer "where does paced p99 live" with a queue-wait vs
service-time split.

Wire-hop spans (kernel/wire.py) keep their meaning across transport
modes: `wire.produce` is the append RPC's service time, `wire.poll` the
broker-append→delivery queue wait — under streaming prefetch the
delivery instant is the deliver frame's ARRIVAL (credit delivery), so
the hop's queue wait never absorbs time records spend in the consumer's
own prefetch buffer (that residency shows up downstream, where it
belongs).

Sampling keeps the hot path honest: at 1M events/s nobody can afford a
span per batch per stage, so only every `sample`-th trace id records
(trace ids are dense counters, so modulo sampling is uniform). Spans
ring per STAGE (one chatty stage — a busy egress shard, a flapping DLQ
— can no longer evict every other stage's spans from a shared ring).

Host stages (kind "host" in TRACE_STAGES) are the process's own work
between the pipeline's hops — the scoring pool's take, dispatch and
settle, garbage collections — which belongs to no trace: they record
on every occurrence, into rings of their own, whatever the sampling.

`Tracer.span(stage, ...)` is the write path for work timed as it runs:
a context manager that stamps the ring's span with `time.monotonic()`
and, while `torch.profiler` runs, opens a profiler range of the same
name, so the span lands on the device trace's clock with no offset
arithmetic (`python -m sitewhere_tpu_torch.tools.flush_profile` and the
benchmark's traced runs read those ranges). With no profiler it costs
one flag check, two clock reads and a ring append. `record()` stays for
spans whose start is back-dated (queue waits). `watch_gc` times every
collection of the process into a runtime's tracer and metrics.

`Tracer.spans()` / `Tracer.trace(trace_id)` are the query surface (REST
exposes them, with tenant filtering and pagination).
"""

from __future__ import annotations

import gc
import itertools
import sys
import threading
import time
import weakref
import zlib
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from sitewhere_tpu_torch.analysis.registry import (  # noqa: F401
    HOST_STAGES,
    TRACE_STAGES,
)
from sitewhere_tpu_torch.kernel.metrics import Histogram


def profiler_range(name: str):
    """A `torch.profiler` range named `name`, opened, while a profiler
    runs; None otherwise (torch not loaded cannot be profiling). Close
    it with `close_range`. It is torch's C++ range (`_RecordFunctionFast`,
    a plain CPU range with no device-side copy): Python's
    `record_function` adds tens of µs inside the range at each end, more
    than the shortest host spans last."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.autograd._profiler_enabled():
        return None
    rf = torch._C._profiler._RecordFunctionFast(name)
    rf.__enter__()
    return rf


def close_range(rf) -> None:
    if rf is not None:
        rf.__exit__(None, None, None)


@contextmanager
def profiled(name: str):
    """A block inside the profiler range `name` while a profiler runs,
    and nothing else: no span and no clock read. For stages inside a
    dispatch, such as the TFT's, which also run under `vmap`."""
    rf = profiler_range(name)
    try:
        yield
    finally:
        close_range(rf)


class _Span:
    """One `Tracer.span` block. `n_events` and `trace_id` may be set
    inside the block, where they are known only there. A block left by
    an exception closes its profiler range and records no span."""

    __slots__ = ("_tracer", "stage", "tenant_id", "trace_id", "n_events",
                 "t_start", "_range")

    def __init__(self, tracer: "Tracer", stage: str, tenant_id: str,
                 trace_id: int, n_events: int):
        self._tracer = tracer
        self.stage = stage
        self.tenant_id = tenant_id
        self.trace_id = trace_id
        self.n_events = n_events

    def __enter__(self) -> "_Span":
        self._range = profiler_range(self.stage)
        self.t_start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        duration = time.monotonic() - self.t_start
        close_range(self._range)
        if exc_type is None:
            # the stage literal is resolved at the `span(...)` call site
            self._tracer.record(self.trace_id, self.stage, self.tenant_id,  # swxlint: disable=TRC01
                                self.t_start, duration, self.n_events)
        return False


@dataclass(frozen=True, slots=True)
class Span:
    trace_id: int
    stage: str            # e.g. "event-sources.decode"
    tenant_id: str
    t_start: float        # monotonic
    duration_s: float
    n_events: int

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "stage": self.stage,
                "tenant": self.tenant_id, "t_start": self.t_start,
                "duration_ms": round(self.duration_s * 1e3, 3),
                "n_events": self.n_events}


class Tracer:
    """Bounded per-stage span rings with modulo sampling. One per
    runtime. `capacity` is the total span budget; each stage's ring gets
    `stage_capacity` (default `capacity // 8`, min 64) so stages evict
    only their own history."""

    def __init__(self, capacity: int = 4096, sample: int = 64,
                 stage_capacity: int = 0):
        self.sample = max(int(sample), 1)
        self.stage_capacity = (max(int(stage_capacity), 1)
                               if stage_capacity
                               else max(capacity // 8, 64))
        self._rings: dict[str, deque[Span]] = {}
        self._ids = itertools.count(1)
        # fleet-wide id scope (set_origin): high bits of every id this
        # process MINTS. 0 = unscoped (single-process deployments keep
        # their small dense ids)
        self._origin = 0

    def set_origin(self, key: str) -> None:
        """Scope trace ids minted HERE to this process: the high 31
        bits become a hash of `key` (worker id), the low 32 bits stay
        the dense counter. Two fleet processes can then never mint the
        same id, so a fleet-merged trace view (`FleetObserver`,
        `ApiServer` trace op) attributes every span unambiguously —
        while `sampled()` stays a pure function of the id, so EVERY
        process along a batch's journey makes the same record/skip
        decision for a trace some other process stamped. Masked to 31
        bits: the full id must stay inside the wire codec's i64."""
        self._origin = (zlib.crc32(key.encode()) & 0x7FFFFFFF) << 32

    @property
    def origin(self) -> int:
        return self._origin

    def new_trace_id(self) -> int:
        """Dense trace ids (stamped at the receiver), origin-scoped
        when `set_origin` ran (fleet workers)."""
        return self._origin | next(self._ids)

    def sampled(self, trace_id: int) -> bool:
        return trace_id > 0 and trace_id % self.sample == 0

    def span(self, stage: str, tenant_id: str = "", trace_id: int = 0,
             n_events: int = 0) -> _Span:
        """`with tracer.span(stage, ...):` times the block into the
        stage's ring (host stages always, per-trace stages when the
        trace is sampled) and, under `torch.profiler`, as a range."""
        return _Span(self, stage, tenant_id, trace_id, n_events)

    def record(self, trace_id: int, stage: str, tenant_id: str,
               t_start: float, duration_s: float, n_events: int = 0) -> None:
        if not self.sampled(trace_id) and stage not in HOST_STAGES:
            return
        ring = self._rings.get(stage)
        if ring is None:
            ring = self._rings[stage] = deque(maxlen=self.stage_capacity)
        ring.append(Span(trace_id, stage, tenant_id, t_start,
                         duration_s, n_events))

    # -- query surface -----------------------------------------------------

    def _all(self) -> Iterable[Span]:
        for ring in self._rings.values():
            yield from ring

    def stages(self) -> list[str]:
        return sorted(self._rings)

    def spans(self, stage: Optional[str] = None,
              tenant: Optional[str] = None,
              limit: int = 256, offset: int = 0) -> list[Span]:
        """Newest-first span listing, filterable by stage and tenant,
        paginated with (offset, limit) — the REST listing surface."""
        if stage is not None:
            source: Iterable[Span] = self._rings.get(stage, ())
        else:
            source = self._all()
        out = [s for s in source
               if tenant is None or s.tenant_id == tenant]
        out.sort(key=lambda s: s.t_start, reverse=True)
        if offset:
            out = out[offset:]
        return out[:limit] if limit >= 0 else out

    def trace(self, trace_id: int,
              tenant: Optional[str] = None) -> list[Span]:
        """Every recorded span of one trace, in time order — the
        pipeline's journey for one ingest batch, receiver →
        egress.publish (plus any off-ramp spans it took)."""
        return sorted((s for s in self._all()
                       if s.trace_id == trace_id
                       and (tenant is None or s.tenant_id == tenant)),
                      key=lambda s: s.t_start)

    def _stage_hist(self, spans: Iterable[Span]) -> tuple[Histogram, int,
                                                          int, float]:
        hist = Histogram("stage")
        events = 0
        count = 0
        total = 0.0
        for s in spans:
            hist.observe(s.duration_s)
            events += s.n_events
            count += 1
            total += s.duration_s
        return hist, count, events, total

    def stage_summary(self, tenant: Optional[str] = None) -> dict[str, dict]:
        """Per-stage p50/p95/p99 duration + event counts over the
        recorded spans (ops dashboard). The quantiles come from the
        ring's raw durations (linear interpolation), not from a
        histogram's fixed buckets, whose edges a tail would snap to."""
        out: dict[str, dict] = {}
        for stage in sorted(self._rings):
            spans = [s for s in self._rings[stage]
                     if tenant is None or s.tenant_id == tenant]
            if not spans:
                continue
            durations = np.fromiter((s.duration_s for s in spans),
                                    np.float64, len(spans))
            p50, p95, p99 = np.quantile(durations, (0.50, 0.95, 0.99))
            out[stage] = {
                "count": len(spans),
                "p50_ms": round(float(p50) * 1e3, 3),
                "p95_ms": round(float(p95) * 1e3, 3),
                "p99_ms": round(float(p99) * 1e3, 3),
                "mean_ms": round(float(durations.mean()) * 1e3, 3),
                "max_ms": round(float(durations.max()) * 1e3, 3),
                "events": sum(s.n_events for s in spans),
            }
        return out

    def stage_export(self, tenant: Optional[str] = None) -> dict[str, dict]:
        """Per-stage summary in MERGEABLE form: histogram bucket counts
        beside count/events/total/max. Per-worker p99s cannot be
        averaged into a fleet p99 — bucket-wise histogram merge keeps
        fleet quantiles exact to bucket resolution, which is what the
        telemetry export publishes and `merge_stage_exports` folds
        (kernel/observe.py beat → fleet/observer.py)."""
        out: dict[str, dict] = {}
        for stage in sorted(self._rings):
            spans = [s for s in self._rings[stage]
                     if tenant is None or s.tenant_id == tenant]
            if not spans:
                continue
            hist, count, events, total = self._stage_hist(spans)
            out[stage] = {
                "count": count,
                "events": events,
                "total_s": total,
                "max_s": hist._max,
                "buckets": list(hist.buckets),
                "counts": list(hist.counts),
            }
        return out

    def critical_path(self, tenant: Optional[str] = None) -> dict:
        """The critical-path report over sampled traces: per-stage
        quantiles in pipeline order, each stage classified queue vs
        service (TRACE_STAGES), and the queue-wait
        vs service-time p99 split — "where does paced p99 live".

        Unregistered stages (tests, future drift) still report, with
        kind "unknown"; TRC01 is the gate that keeps the live tree's
        stages registered. Host stages belong to no trace and are left
        out (`stage_summary` lists them)."""
        kinds = dict(TRACE_STAGES)
        order = {name: i for i, (name, _) in enumerate(TRACE_STAGES)}
        summary = self.stage_summary(tenant=tenant)
        stages: dict[str, dict] = {}
        queue_p99 = service_p99 = 0.0
        span_count = 0
        for stage in sorted(summary, key=lambda s: order.get(s, 1000)):
            if stage in HOST_STAGES:
                continue
            kind = kinds.get(stage, "unknown")
            row = {**summary[stage], "kind": kind}
            stages[stage] = row
            span_count += row["count"]
            if kind == "queue":
                queue_p99 += row["p99_ms"]
            elif kind == "service":
                service_p99 += row["p99_ms"]
        return {
            "stages": stages,
            "span_count": span_count,
            "queue_wait_p99_ms": round(queue_p99, 3),
            "service_p99_ms": round(service_p99, 3),
            "sample": self.sample,
        }


class NullTracer(Tracer):
    """A tracer that keeps nothing, for components built without a
    runtime (tests, tools), so their call sites need no branch. Its
    spans are still profiler ranges while `torch.profiler` runs."""

    def record(self, trace_id: int, stage: str, tenant_id: str,
               t_start: float, duration_s: float, n_events: int = 0) -> None:
        return None


NULL_TRACER = NullTracer()


# -- garbage collections -----------------------------------------------------
# `gc.callbacks` is process-wide: one hook (`_on_gc`) is installed while
# any runtime watches and fans each collection out to every watcher. A
# watcher holds its tracer weakly: a runtime dropped without a stop
# leaves a dead watcher, which the hook skips and the next `watch_gc` or
# `unwatch_gc` removes, so no forgotten runtime taxes later collections.

GC_PAUSE_BUCKETS = [1e-5 * 2 ** i for i in range(18)]   # 10 µs … 1.31 s


class GcWatch:
    """One runtime's share of the hook: its tracer (weakly) and its
    metrics."""

    __slots__ = ("tracer", "collections", "pause")

    def __init__(self, tracer: Tracer, metrics):
        self.tracer = weakref.ref(tracer)
        self.collections = [metrics.counter(f"runtime.gc_collections:{gen}")
                            for gen in ("gen0", "gen1", "gen2")]
        self.pause = metrics.histogram("runtime.gc_pause_s",
                                       buckets=GC_PAUSE_BUCKETS)


class _GcClock:
    __slots__ = ("t_start", "range")

    def __init__(self):
        self.t_start: Optional[float] = None
        self.range = None


# one collection runs at a time, so the hook's clock needs no lock; the
# watchers are replaced whole under `_gc_lock` and read lock-free
_gc_watches: tuple[GcWatch, ...] = ()
_gc_clock = _GcClock()
_gc_lock = threading.Lock()


def _on_gc(phase: str, info: dict) -> None:
    """Every collection, in whatever thread ran it: a profiler range
    (`runtime.gc.full` for generation 2, `runtime.gc.young` else), and
    in each watching runtime its counter and pause; generation 2 also a
    host span whose `n_events` is the objects collected."""
    full = info["generation"] == 2
    if phase == "start":
        _gc_clock.range = profiler_range(
            "runtime.gc.full" if full else "runtime.gc.young")
        _gc_clock.t_start = time.monotonic()
        return
    t_start = _gc_clock.t_start
    if t_start is None:   # the hook came in mid-collection
        return
    pause = time.monotonic() - t_start
    close_range(_gc_clock.range)
    _gc_clock.t_start = _gc_clock.range = None
    for watch in _gc_watches:
        tracer = watch.tracer()
        if tracer is None:   # its runtime is gone
            continue
        watch.collections[info["generation"]].inc()
        watch.pause.observe(pause)
        if full:
            tracer.record(0, "runtime.gc.full", "", t_start, pause,
                          info["collected"])


def watch_gc(tracer: Tracer, metrics) -> GcWatch:
    """Time every garbage collection of the process into `tracer` and
    `metrics` until `unwatch_gc`; installs the hook on the first."""
    global _gc_watches
    watch = GcWatch(tracer, metrics)
    with _gc_lock:
        _gc_watches = (*_live_watches(), watch)
        if _on_gc not in gc.callbacks:
            gc.callbacks.append(_on_gc)
    return watch


def unwatch_gc(watch: GcWatch) -> None:
    """Stop `watch`; the last one out removes the hook."""
    global _gc_watches
    with _gc_lock:
        _gc_watches = tuple(w for w in _live_watches() if w is not watch)
        if not _gc_watches and _on_gc in gc.callbacks:
            gc.callbacks.remove(_on_gc)


def _live_watches() -> tuple[GcWatch, ...]:
    return tuple(w for w in _gc_watches if w.tracer() is not None)


def merge_stage_exports(exports: Iterable[dict]) -> dict:
    """Fold per-process `stage_export` dicts into ONE fleet critical
    path: bucket counts merge additively per stage, quantiles are read
    off the merged histogram, and the queue-vs-service split is
    computed exactly as `Tracer.critical_path` does locally — the
    fleet-level answer to "where does paced p99 live" when the spine
    crosses worker processes (fleet/observer.py)."""
    merged: dict[str, dict] = {}
    for export in exports:
        for stage, row in (export or {}).items():
            if stage in HOST_STAGES:
                continue  # no trace's: out of the critical path
            agg = merged.get(stage)
            if agg is None:
                agg = merged[stage] = {
                    "count": 0, "events": 0, "total_s": 0.0, "max_s": 0.0,
                    "buckets": list(row.get("buckets") or ()),
                    "counts": [0] * len(row.get("counts") or ()),
                    "mixed": False,
                }
            agg["count"] += int(row.get("count", 0))
            agg["events"] += int(row.get("events", 0))
            agg["total_s"] += float(row.get("total_s", 0.0))
            agg["max_s"] = max(agg["max_s"], float(row.get("max_s", 0.0)))
            counts = row.get("counts") or ()
            if agg["mixed"]:
                continue
            if len(counts) == len(agg["counts"]):
                for i, c in enumerate(counts):
                    agg["counts"][i] += int(c)
            else:
                # bucket-shape drift across versions: bucket fidelity
                # is unrecoverable for this stage — flag it ONCE and
                # report quantiles as the max upper bound below, the
                # same answer whatever order exports arrive in
                agg["mixed"] = True
    kinds = dict(TRACE_STAGES)
    order = {name: i for i, (name, _) in enumerate(TRACE_STAGES)}
    stages: dict[str, dict] = {}
    queue_p99 = service_p99 = 0.0
    span_count = 0
    for stage in sorted(merged, key=lambda s: order.get(s, 1000)):
        agg = merged[stage]
        if agg["mixed"]:
            # count-only merge: the honest quantile is unknowable, so
            # every quantile reports the conservative max upper bound
            q50 = q95 = q99 = agg["max_s"]
        else:
            hist = Histogram("stage", buckets=agg["buckets"] or None)
            hist.counts = list(agg["counts"]) + [0] * (
                len(hist.buckets) + 1 - len(agg["counts"]))
            hist.count = agg["count"]
            hist._max = agg["max_s"]
            q50, q95, q99 = (hist.quantile(0.50), hist.quantile(0.95),
                             hist.quantile(0.99))
        kind = kinds.get(stage, "unknown")
        row = {
            "count": agg["count"],
            "p50_ms": round(q50 * 1e3, 3),
            "p95_ms": round(q95 * 1e3, 3),
            "p99_ms": round(q99 * 1e3, 3),
            "mean_ms": round(agg["total_s"] / max(agg["count"], 1) * 1e3, 3),
            "max_ms": round(agg["max_s"] * 1e3, 3),
            "events": agg["events"],
            "kind": kind,
        }
        stages[stage] = row
        span_count += agg["count"]
        if kind == "queue":
            queue_p99 += row["p99_ms"]
        elif kind == "service":
            service_p99 += row["p99_ms"]
    return {
        "stages": stages,
        "span_count": span_count,
        "queue_wait_p99_ms": round(queue_p99, 3),
        "service_p99_ms": round(service_p99, 3),
    }
