"""What the tracer's host spans and the garbage-collection hook cost with
no profiler running, on this host's CPU.

    python -m sitewhere_tpu_torch.tools.span_cost [--n N]

Prints one JSON line of nanoseconds, medians of five rounds of N calls:
`span_host` (a host stage's `with tracer.span(...)`, recorded into its
ring), `span_trace_unsampled` and `span_trace_sampled` (a per-trace
stage whose trace the modulo sampling skips or keeps), `record_host`
(the ring append alone), `gc_callback` (one collection's start and stop
calls of the hook with one runtime watching), and `collect_gen0` with
and without the hook (`gc.collect(0)` on a small heap).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import time

from sitewhere_tpu_torch.kernel import tracing
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry


def _ns(fn, n: int) -> float:
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        rounds.append((time.perf_counter_ns() - t0) / n)
    return statistics.median(rounds)


def measure(n: int) -> dict:
    tracer = tracing.Tracer(sample=64)

    def span_host():
        with tracer.span("scoring.dispatch"):
            pass

    def span_trace(trace_id):
        def fn():
            with tracer.span("event-management.persist", "t", trace_id):
                pass
        return fn

    def record_host():
        tracer.record(0, "scoring.settle", "", 0.0, 0.0)

    watch = tracing.watch_gc(tracer, MetricsRegistry())
    start, stop = ({"generation": 0, "collected": 0, "uncollectable": 0},
                   {"generation": 0, "collected": 0, "uncollectable": 0})

    def callback():
        tracing._on_gc("start", start)
        tracing._on_gc("stop", stop)

    try:
        out = {"span_host": _ns(span_host, n),
               "span_trace_unsampled": _ns(span_trace(1), n),
               "span_trace_sampled": _ns(span_trace(64), n),
               "record_host": _ns(record_host, n),
               "gc_callback": _ns(callback, n),
               "collect_gen0_hooked": _ns(lambda: gc.collect(0), n // 10)}
    finally:
        tracing.unwatch_gc(watch)
    out["collect_gen0_bare"] = _ns(lambda: gc.collect(0), n // 10)
    return {k: round(v, 1) for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "sitewhere_tpu_torch.tools.span_cost",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=100_000)
    args = ap.parse_args(argv)
    print(json.dumps(measure(args.n)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
