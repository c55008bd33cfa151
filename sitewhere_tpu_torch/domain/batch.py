"""Columnar event batches + the SWB1 binary wire protocol (measurements).

Devices (or gateways) emit telemetry in SWB1, a fixed-stride
little-endian columnar format; decoding is a handful of `np.frombuffer`
views. Batches stay columnar (struct-of-arrays) through decode → persist
→ score, and the arrays feed `torch.from_numpy` directly.

SWB1 layout (little-endian):
  header: magic b"SWB1" | msg_type u8 | flags u8 | count u32   (10 bytes)
  measurements (msg_type=1): device_index u32[N] | mtype u16[N]
                             | value f32[N] | ts f64[N]
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
import numpy as np

MAGIC = b"SWB1"
MSG_MEASUREMENTS = 1

_HEADER = struct.Struct("<4sBBI")


@dataclass(slots=True)
class BatchContext:
    """Trace/latency envelope carried with every batch.

    `ingest_monotonic` is stamped when the receiver first sees the payload;
    end-to-end latency is measured against it at the scoring sink.
    """

    tenant_id: str
    source: str = ""
    trace_id: int = 0
    ingest_monotonic: float = field(default_factory=time.monotonic)


@dataclass(slots=True)
class MeasurementBatch:
    """N scalar measurements, columnar. The hot-path record type."""

    ctx: BatchContext
    device_index: np.ndarray  # uint32 [N] dense per-tenant device slot
    mtype: np.ndarray         # uint16 [N] channel id within device type
    value: np.ndarray         # float32 [N]
    ts: np.ndarray            # float64 [N] epoch seconds (event_date)

    def __len__(self) -> int:
        return int(self.device_index.shape[0])

    # -- SWB1 codec --------------------------------------------------------

    def encode(self) -> bytes:
        n = len(self)
        return b"".join((
            _HEADER.pack(MAGIC, MSG_MEASUREMENTS, 0, n),
            np.ascontiguousarray(self.device_index, np.uint32).tobytes(),
            np.ascontiguousarray(self.mtype, np.uint16).tobytes(),
            np.ascontiguousarray(self.value, np.float32).tobytes(),
            np.ascontiguousarray(self.ts, np.float64).tobytes(),
        ))

    @staticmethod
    def decode(payload: bytes | memoryview, ctx: BatchContext) -> "MeasurementBatch":
        magic, msg_type, _flags, n = _HEADER.unpack_from(payload, 0)
        if magic != MAGIC or msg_type != MSG_MEASUREMENTS:
            raise ValueError(f"not an SWB1 measurement batch (type={msg_type})")
        mv = memoryview(payload)
        o = _HEADER.size
        dev = np.frombuffer(mv, np.uint32, n, o); o += 4 * n
        mtype = np.frombuffer(mv, np.uint16, n, o); o += 2 * n
        value = np.frombuffer(mv, np.float32, n, o); o += 4 * n
        ts = np.frombuffer(mv, np.float64, n, o)
        return MeasurementBatch(ctx, dev, mtype, value, ts)



@dataclass(slots=True)
class ScoredBatch:
    """Output of the model plane for one scored MeasurementBatch:
    per-event anomaly scores + the boolean alert decisions."""

    ctx: BatchContext
    device_index: np.ndarray  # uint32 [N]
    score: np.ndarray         # float32 [N]
    is_anomaly: np.ndarray    # bool [N]
    ts: np.ndarray            # float64 [N]
    model_version: int = 0
    # sparse anomaly readback (ScoringConfig.readback="anomalies"): the
    # batch carries ONLY the anomalous events; this is how many events
    # the flush actually scored on the device. -1 = full readback
    total_scored: int = -1

    def __len__(self) -> int:
        return int(self.device_index.shape[0])

    def select(self, mask: np.ndarray) -> "ScoredBatch":
        return ScoredBatch(self.ctx, self.device_index[mask],
                           self.score[mask], self.is_anomaly[mask],
                           self.ts[mask], self.model_version,
                           self.total_scored)
