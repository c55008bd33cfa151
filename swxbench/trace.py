"""The traced run's stretch: `torch.profiler` over a steady part of the
window, with the program's spans and counters read over the same time.

The stretch starts `STRETCH_AT` of the way into the window and lasts
`STRETCH_S`, or half the window where that is shorter. Across it the
harness keeps every span the program's tracer records for the stages it
reads (the tracer samples every trace in a traced run; its rings are
read every `SPAN_POLL_S`, each poll taking only the spans newer than the
last, and a ring that turned over between two polls is counted in
`evicted`), the scoring dispatch counter, K1's launch counter and the
scored events its consumer saw. The
profiler's own labels (`scoring.dispatch`) and the device's kernels
come from the trace. Reduced after the drain: device busy time (the
union of device intervals), kernel time by name, and the longest idle
gaps, each named by the program span, or else the host operation, open
at its middle.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

STAGES = ("event-sources.decode", "inbound.enrich",
          "event-management.persist", "rule-processing.dispatch",
          "rule-processing.score", "egress.publish")
STRETCH_AT = 0.4
STRETCH_S = 3.0
SPAN_POLL_S = 0.5
MARK = "swxbench.stretch"
TOP = 10


def _union(intervals) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


@dataclass
class Stretch:
    at: float = STRETCH_AT
    seconds: float = STRETCH_S
    t0: float = 0.0                 # monotonic
    t1: float = 0.0
    spans: dict = field(default_factory=dict)    # stage → [Span]
    newest: dict = field(default_factory=dict)   # stage → t_start read
    evicted: dict = field(default_factory=dict)  # stage → polls that lost
    counters0: dict = field(default_factory=dict)
    counters1: dict = field(default_factory=dict)
    prof: object = None
    reduced: dict = field(default_factory=dict)

    def prepare(self) -> None:
        """Start and stop the profiler once in the set-up, so that its
        first start (CUPTI's loading) falls outside the window."""
        import torch
        from torch.profiler import profile

        cuda = torch.cuda.is_available()
        with profile(activities=_activities()):
            torch.ones(1, device="cuda" if cuda else "cpu").add_(1)
        if cuda:
            torch.cuda.synchronize()

    def _counters(self, dep, consumer) -> dict:
        from sitewhere_tpu_torch.ops import lstm_kernel

        return {"dispatches": dep.counter("scoring.dispatches"),
                "k1_launches": int(lstm_kernel.launches),
                "events": consumer.events}

    def _collect(self, tracer) -> None:
        for stage in STAGES:
            newest = self.newest.get(stage, self.t0)
            fresh = []
            listed = tracer.spans(stage=stage, limit=-1)   # newest first
            for s in listed:
                if s.t_start <= newest:
                    break
                if s.t_start < self.t1:
                    fresh.append(s)
            else:
                # every span in the ring is new: older ones may be gone
                if listed:
                    self.evicted[stage] = self.evicted.get(stage, 0) + 1
            if listed:
                self.newest[stage] = max(newest, listed[0].t_start)
            self.spans.setdefault(stage, []).extend(fresh)

    async def run(self, dep, consumer, t_window0: float,
                  window_s: float) -> None:
        import torch
        from torch.profiler import profile, record_function

        self.seconds = min(self.seconds, 0.5 * window_s)
        start = t_window0 + self.at * window_s
        await asyncio.sleep(max(start - time.monotonic(), 0.0))
        self.counters0 = self._counters(dep, consumer)
        prof = profile(activities=_activities())
        prof.start()
        mark = record_function(MARK)
        mark.__enter__()
        self.t0 = time.monotonic()
        self.t1 = self.t0 + self.seconds
        self.newest = dict.fromkeys(STAGES, self.t0)
        while time.monotonic() < self.t1:
            await asyncio.sleep(min(SPAN_POLL_S,
                                    max(self.t1 - time.monotonic(), 0.0)))
            self._collect(dep.rt.tracer)
        mark.__exit__(None, None, None)
        self.t1 = time.monotonic()
        self.counters1 = self._counters(dep, consumer)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        self._collect(dep.rt.tracer)
        self.prof = prof

    def delta(self, name: str) -> int:
        return self.counters1[name] - self.counters0[name]

    def reduce(self) -> dict:
        """Device intervals, host ranges and gaps from the trace (µs on
        the profiler's clock)."""
        from torch.autograd import DeviceType

        lo = hi = None
        device, host = [], []
        for e in self.prof.events():
            span = (e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CPU:
                if e.name == MARK:
                    lo, hi = span
                else:
                    host.append((e.name, span))
            elif (e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)):
                # a label's device-side copy is no device work
                device.append((e.name, span))
        if lo is None:
            raise RuntimeError("the stretch's own label is not in the trace")
        device = [(n, (max(a, lo), min(b, hi))) for n, (a, b) in device
                  if b > lo and a < hi]
        busy_us = _union(s for _, s in device)
        by_kernel: dict[str, float] = {}
        for name, (a, b) in device:
            by_kernel[name] = by_kernel.get(name, 0.0) + (b - a)
        ranges: dict[str, list] = {}
        for name, (a, b) in host:
            ranges.setdefault(name, []).append(b - a)
        self.reduced = {
            "window_us": hi - lo, "busy_us": busy_us,
            "by_kernel_us": by_kernel, "host_ranges_us": ranges,
            "device_ops": len(device),
            "idle_gaps": self._gaps(lo, hi, device, host),
        }
        return self.reduced

    def _gaps(self, lo: float, hi: float, device, host) -> list:
        ends, gaps, end = [], [], lo
        for a, b in sorted(s for _, s in device):
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if hi > end:
            gaps.append((end, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        # program spans on the profiler's clock: the stretch's label
        # opened at `t0` on the monotonic clock
        spans = [(st, (lo + (s.t_start - self.t0) * 1e6,
                       lo + (s.t_start + s.duration_s - self.t0) * 1e6))
                 for st, ss in self.spans.items() for s in ss]
        for a, b in gaps[:TOP]:
            mid = 0.5 * (a + b)
            name = _innermost(spans, mid) or _innermost(host, mid) or "idle"
            ends.append([name, (b - a) / 1e6])
        return ends


def _activities() -> list:
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def _innermost(named, t: float):
    best, best_start = None, float("-inf")
    for name, (a, b) in named:
        if a <= t < b and a > best_start:
            best, best_start = name, a
    return best
