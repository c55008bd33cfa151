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
shrinks the workload.
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


def corpus(root: str):
    """Write and compact the corpus; returns (cold-tier store, the
    (device_index, value, ts) blocks in log order, compaction report,
    compaction seconds)."""
    rng = np.random.default_rng(7)
    log = SegmentLog(os.path.join(root, "events"), segment_bytes=8 << 20)
    remaining, t, blocks = EVENTS, 1_700_000_000.0, []
    while remaining > 0:
        n = min(BLOCK, remaining)
        dev = rng.integers(0, DEVICES, n).astype(np.uint32)
        ts = (t + np.sort(rng.random(n)) * WINDOW_S).astype(np.float64)
        val = rng.normal(20.0, 5.0, n).astype(np.float32)
        log.append(RT_MEASUREMENTS, MeasurementBatch(
            BatchContext(TENANT), dev, np.zeros(n, np.uint16), val,
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


def pool():
    """The bench's replay pool on the card; returns (pool, model)."""
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool

    model = build_model("lstm-stream", window=WINDOW)
    return SharedScoringPool(model, MetricsRegistry(), PoolConfig(
        batch_buckets=BUCKETS, batch_window_ms=2.0, max_inflight=8)), model
