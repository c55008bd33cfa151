"""The bench's replay workload at full width, as `chip_smoke.py` and
`tools/flush_profile.py --path replay` drive it.

`corpus(root)` writes the corpus of `bench.py --replay`
(`bench.py:2170-2196`): `EVENTS` measurement events over `DEVICES`
devices, in blocks of `BLOCK` events that each span one `WINDOW_S`
window with sorted timestamps, values N(20, 5), numpy seed 7, appended
to a durable segment log under `root/events` and compacted into the
cold tier under `root/history`. `pool()` is the pool the bench replays
through (`bench.py:2204-2207`): `lstm-stream` at window 64, buckets
256/1024/4096/8192, a 2 ms window, 8 flushes in flight, on the card.
The module's sizes are read when the functions run, so setting them
shrinks the workload; `corpus` and `pool` also take the bench's flags
(`--replay-events` split over `--tenants`, `--devices`, `--model`, ...),
as `tools/bench.py --replay` passes them.
"""

from __future__ import annotations

import os
import time

import numpy as np

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.history import EventHistoryStore
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.persistence.durable import RT_MEASUREMENTS, SegmentLog

EVENTS, DEVICES = 500_000, 32768
WINDOW_S, BLOCK = 60.0, 65536
BUCKETS = (256, 1024, 4096, 8192)
WINDOW, THRESHOLD = 64, 6.0
TENANT = "bench"


def corpus(root: str, tenant: str = TENANT, events: int | None = None,
           devices: int | None = None, rng=None):
    """Write and compact `tenant`'s corpus (`events` over `devices`,
    default `EVENTS` over `DEVICES`; `rng` default numpy seed 7, one
    generator drawn on across tenants as the bench does); returns
    (cold-tier store, the (device_index, value, ts) blocks in log
    order, compaction report, compaction seconds)."""
    rng = np.random.default_rng(7) if rng is None else rng
    events = EVENTS if events is None else events
    devices = DEVICES if devices is None else devices
    log = SegmentLog(os.path.join(root, "events"), segment_bytes=8 << 20)
    remaining, t, blocks = events, 1_700_000_000.0, []
    while remaining > 0:
        n = min(BLOCK, remaining)
        dev = rng.integers(0, devices, n).astype(np.uint32)
        ts = (t + np.sort(rng.random(n)) * WINDOW_S).astype(np.float64)
        val = rng.normal(20.0, 5.0, n).astype(np.float32)
        log.append(RT_MEASUREMENTS, MeasurementBatch(
            BatchContext(tenant), dev, np.zeros(n, np.uint16), val,
            ts).encode())
        blocks.append((dev, val, ts))
        remaining -= n
        t += WINDOW_S
    log.close()
    store = EventHistoryStore(os.path.join(root, "history"), source=log,
                              window_s=WINDOW_S)
    t0 = time.perf_counter()
    report = store.compact(through_seq=log._seq)
    return store, blocks, report, time.perf_counter() - t0


def pool(model: str = "lstm-stream", window: int = WINDOW,
         window_ms: float = 2.0, max_inflight: int = 8, device=None,
         metrics=None):
    """The bench's replay pool (`--model`, `--window`, `--window-ms`,
    `--max-inflight`) on the card unless `device` names another; returns
    (pool, model)."""
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool

    scorer = build_model(model, device=device, window=window)
    metrics = MetricsRegistry() if metrics is None else metrics
    return SharedScoringPool(scorer, metrics, PoolConfig(
        batch_buckets=BUCKETS, batch_window_ms=window_ms,
        max_inflight=max_inflight), device=device), scorer
