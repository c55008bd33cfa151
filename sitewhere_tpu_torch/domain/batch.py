"""Columnar event batches + the SWB1 binary wire protocol.

This module is the core of the data plane. The reference moves
one protobuf-encoded event per MQTT message and re-marshals it at every
hop (agent proto → POJO → Kafka proto → POJO..., [SURVEY.md §2.1
"Protobuf wire model", §3.2]); at 1M events/sec that per-event cost is the
wall. Here:

- Devices emit (or gateways aggregate) **batches** of telemetry in SWB1, a
  fixed-stride little-endian columnar format. Decoding is a handful of
  `np.frombuffer` views — nanoseconds per event, independent of batch size.
- Batches stay columnar (struct-of-arrays) through decode → enrich →
  persist → score; the arrays feed `torch.from_numpy` directly with no
  per-event materialization.
- Per-event objects (`domain.events`) are produced only at the API/query
  surface.

SWB1 layout (little-endian):
  header: magic b"SWB1" | msg_type u8 | flags u8 | count u32   (10 bytes)
  measurements (msg_type=1): device_index u32[N] | mtype u16[N]
                             | value f32[N] | ts f64[N]
  locations    (msg_type=2): device_index u32[N] | lat f64[N] | lon f64[N]
                             | elevation f32[N] | ts f64[N]
JSON fallback decoders for token-addressed payloads (registration, alerts,
low-rate devices) live in `services/event_sources.py`.
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np

MAGIC = b"SWB1"
MSG_MEASUREMENTS = 1
MSG_LOCATIONS = 2
# compact agent protocol (reference: the separate `sitewhere.proto`
# device payloads — RegisterDevice / RegistrationAck [SURVEY.md §2.1]):
# a device self-registers over ANY transport that carries SWB1 frames
# (MQTT/TCP/WebSocket) and receives a binary ack on its command topic
MSG_REGISTRATION = 3
MSG_REGISTRATION_ACK = 4

_HEADER = struct.Struct("<4sBBI")


def _w_str(parts: list, s: str) -> None:
    b = (s or "").encode("utf-8")
    parts.append(len(b).to_bytes(2, "little"))
    parts.append(b)


def _r_str(mv: memoryview, o: int) -> tuple[str, int]:
    n = int.from_bytes(mv[o:o + 2], "little")
    o += 2
    return bytes(mv[o:o + n]).decode("utf-8"), o + n


@dataclass(slots=True)
class BatchContext:
    """Trace/latency envelope carried with every batch [SURVEY.md §5.1].

    `ingest_monotonic` is stamped when the receiver first sees the payload;
    end-to-end p99 latency is measured against it at the scoring sink.
    """

    tenant_id: str
    source: str = ""
    trace_id: int = 0
    ingest_monotonic: float = field(default_factory=time.monotonic)
    # set by the fused ingress fast lane (kernel/fastlane.py) when it has
    # already performed the scoring admit for this batch: the enriched-hop
    # consumer must not admit it a second time. A declared field (not a
    # dynamic attribute) because BatchContext is slotted and the flag must
    # survive the wire codec's field-dict round trip.
    fastlane: bool = False


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

    @staticmethod
    def concat(batches: Sequence["MeasurementBatch"]) -> "MeasurementBatch":
        assert batches, "concat of empty batch list"
        return MeasurementBatch(
            batches[0].ctx,
            np.concatenate([b.device_index for b in batches]),
            np.concatenate([b.mtype for b in batches]),
            np.concatenate([b.value for b in batches]),
            np.concatenate([b.ts for b in batches]),
        )

    def select(self, mask: np.ndarray) -> "MeasurementBatch":
        return MeasurementBatch(self.ctx, self.device_index[mask],
                                self.mtype[mask], self.value[mask], self.ts[mask])


@dataclass(slots=True)
class LocationBatch:
    """N GPS fixes, columnar."""

    ctx: BatchContext
    device_index: np.ndarray  # uint32 [N]
    latitude: np.ndarray      # float64 [N]
    longitude: np.ndarray     # float64 [N]
    elevation: np.ndarray     # float32 [N]
    ts: np.ndarray            # float64 [N]

    def __len__(self) -> int:
        return int(self.device_index.shape[0])

    def encode(self) -> bytes:
        n = len(self)
        return b"".join((
            _HEADER.pack(MAGIC, MSG_LOCATIONS, 0, n),
            np.ascontiguousarray(self.device_index, np.uint32).tobytes(),
            np.ascontiguousarray(self.latitude, np.float64).tobytes(),
            np.ascontiguousarray(self.longitude, np.float64).tobytes(),
            np.ascontiguousarray(self.elevation, np.float32).tobytes(),
            np.ascontiguousarray(self.ts, np.float64).tobytes(),
        ))

    @staticmethod
    def decode(payload: bytes | memoryview, ctx: BatchContext) -> "LocationBatch":
        magic, msg_type, _flags, n = _HEADER.unpack_from(payload, 0)
        if magic != MAGIC or msg_type != MSG_LOCATIONS:
            raise ValueError(f"not an SWB1 location batch (type={msg_type})")
        mv = memoryview(payload)
        o = _HEADER.size
        dev = np.frombuffer(mv, np.uint32, n, o); o += 4 * n
        lat = np.frombuffer(mv, np.float64, n, o); o += 8 * n
        lon = np.frombuffer(mv, np.float64, n, o); o += 8 * n
        elev = np.frombuffer(mv, np.float32, n, o); o += 4 * n
        ts = np.frombuffer(mv, np.float64, n, o)
        return LocationBatch(ctx, dev, lat, lon, elev, ts)

    def select(self, mask: np.ndarray) -> "LocationBatch":
        return LocationBatch(self.ctx, self.device_index[mask],
                             self.latitude[mask], self.longitude[mask],
                             self.elevation[mask], self.ts[mask])


@dataclass(slots=True)
class AlertBatch:
    """Device-originated alerts (cold path; strings stay as lists)."""

    ctx: BatchContext
    device_index: np.ndarray          # uint32 [N]
    level: np.ndarray                 # uint8 [N] (AlertLevel values)
    type: list[str] = field(default_factory=list)
    message: list[str] = field(default_factory=list)
    ts: Optional[np.ndarray] = None   # float64 [N]
    source: str = "device"

    def __len__(self) -> int:
        return int(self.device_index.shape[0])

    def select(self, mask: np.ndarray) -> "AlertBatch":
        idx = np.nonzero(mask)[0]
        return AlertBatch(
            self.ctx, self.device_index[idx], self.level[idx],
            [self.type[i] for i in idx], [self.message[i] for i in idx],
            self.ts[idx] if self.ts is not None else None, self.source)


@dataclass(slots=True)
class RegistrationBatch:
    """Device self-registration requests (cold path) [SURVEY.md §2.2
    device-registration]: hardware tokens + requested device type."""

    ctx: BatchContext
    device_tokens: list[str]
    device_type_token: str
    area_token: Optional[str] = None
    customer_token: Optional[str] = None
    metadata: dict = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.device_tokens)

    # -- SWB1 agent codec (MSG_REGISTRATION) --------------------------------

    def encode(self) -> bytes:
        import json as _json

        parts = [_HEADER.pack(MAGIC, MSG_REGISTRATION, 0, len(self))]
        _w_str(parts, self.device_type_token)
        _w_str(parts, self.area_token or "")
        _w_str(parts, self.customer_token or "")
        _w_str(parts, _json.dumps(self.metadata) if self.metadata else "")
        for token in self.device_tokens:
            _w_str(parts, token)
        return b"".join(parts)

    @staticmethod
    def decode(payload: bytes | memoryview,
               ctx: BatchContext) -> "RegistrationBatch":
        import json as _json

        magic, msg_type, _flags, n = _HEADER.unpack_from(payload, 0)
        if magic != MAGIC or msg_type != MSG_REGISTRATION:
            raise ValueError(f"not an SWB1 registration (type={msg_type})")
        mv = memoryview(payload)
        o = _HEADER.size
        dt_token, o = _r_str(mv, o)
        area_token, o = _r_str(mv, o)
        customer_token, o = _r_str(mv, o)
        meta_json, o = _r_str(mv, o)
        tokens = []
        for _ in range(n):
            t, o = _r_str(mv, o)
            tokens.append(t)
        return RegistrationBatch(ctx, tokens, dt_token,
                                 area_token=area_token or None,
                                 customer_token=customer_token or None,
                                 metadata=_json.loads(meta_json)
                                 if meta_json else {})


# registration ack statuses (MSG_REGISTRATION_ACK)
ACK_NEW = 0            # device created + assigned
ACK_ALREADY = 1        # token already registered (redelivery/idempotent)
ACK_REJECTED = 2       # policy refused (unknown type, registration off)


@dataclass(slots=True)
class RegistrationAck:
    """Binary ack sent back down the device's command topic after a
    MSG_REGISTRATION round trip (reference: RegistrationAck proto)."""

    device_tokens: list[str]
    status: list[int]          # ACK_* per token
    device_index: list[int]    # dense index per token (-1 if rejected)

    def __len__(self) -> int:
        return len(self.device_tokens)

    def encode(self) -> bytes:
        parts = [_HEADER.pack(MAGIC, MSG_REGISTRATION_ACK, 0, len(self))]
        for token, st, idx in zip(self.device_tokens, self.status,
                                  self.device_index):
            _w_str(parts, token)
            parts.append(bytes([st]))
            parts.append(int(idx & 0xFFFFFFFF).to_bytes(4, "little"))
        return b"".join(parts)

    @staticmethod
    def decode(payload: bytes | memoryview) -> "RegistrationAck":
        magic, msg_type, _flags, n = _HEADER.unpack_from(payload, 0)
        if magic != MAGIC or msg_type != MSG_REGISTRATION_ACK:
            raise ValueError(f"not an SWB1 registration ack (type={msg_type})")
        mv = memoryview(payload)
        o = _HEADER.size
        tokens, status, index = [], [], []
        for _ in range(n):
            t, o = _r_str(mv, o)
            tokens.append(t)
            status.append(mv[o])
            o += 1
            raw = int.from_bytes(mv[o:o + 4], "little")
            index.append(raw if raw != 0xFFFFFFFF else -1)
            o += 4
        return RegistrationAck(tokens, status, index)


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
    # the flush actually scored on device. -1 = full readback (len(self))
    total_scored: int = -1

    def __len__(self) -> int:
        return int(self.device_index.shape[0])

    def select(self, mask: np.ndarray) -> "ScoredBatch":
        return ScoredBatch(self.ctx, self.device_index[mask],
                           self.score[mask], self.is_anomaly[mask],
                           self.ts[mask], self.model_version,
                           self.total_scored)
