"""Device timing on the card with CUDA events.

`cuda_median_ms` times one call of `fn` between two events (the host's
launch cost included when the device waits on it); `graph_ms` captures
back-to-back calls in one CUDA graph and replays it, so the time is the
device's alone. Both need a CUDA device. Host steps of a hot path are
labelled by the runtime's tracer (`kernel/tracing.py` `Tracer.span`).
"""

from __future__ import annotations

import statistics

import torch


def cuda_median_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median over `reps` of one call of `fn` between CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, launches: int = 20, reps: int = 10) -> float:
    """Device time per call of `fn`: `launches` calls captured in one CUDA
    graph, replayed between CUDA events (median of `reps`)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_median_ms(graph.replay, reps=reps) / launches
