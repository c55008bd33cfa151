"""The Kafka wire endpoint on both packages, byte for byte.

The same request sequences (the whole served set: ApiVersions, Metadata,
Produce v0/v1, Fetch, ListOffsets, FindCoordinator, OffsetCommit,
OffsetFetch, the refusals) go to the JAX package's `KafkaEndpoint` and
the port's, each over an empty bus of its own package. Every response
must be the same bytes. Two things differ between the endpoints by
construction and are held fixed: the broker entry (the listening port)
is replaced by a placeholder, and both buses stamp records from one
fixed clock. Also: the quota's `throttle_time_ms` on Produce v1 with the
records still accepted, a seeded fuzz of 500 requests after which the
endpoint still answers, and each package's Fetch reading back what the
other package's encoding produced. Every await has its own limit.
"""

import asyncio
import struct
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu.domain import batch as jbatch
from sitewhere_tpu.kernel import bus as jbus
from sitewhere_tpu.kernel import codec as jcodec
from sitewhere_tpu.kernel import flow as jflow
from sitewhere_tpu.kernel import kafka_endpoint as jkafka
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.kernel import bus as tbus
from sitewhere_tpu_torch.kernel import codec as tcodec
from sitewhere_tpu_torch.kernel import flow as tflow
from sitewhere_tpu_torch.kernel import kafka_endpoint as tkafka

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(bus=jbus, codec=jcodec, kafka=jkafka, flow=jflow,
                      config=jconfig, batch=jbatch)
PORT = SimpleNamespace(bus=tbus, codec=tcodec, kafka=tkafka, flow=tflow,
                       config=tconfig, batch=tbatch)

STEP = 10.0
FIXED_CLOCK = SimpleNamespace(time=lambda: 1_700_000_000.25,
                              monotonic=time.monotonic)
BROKER = b"<broker>"
FUZZ_FRAMES = 500


@pytest.fixture
def fixed_clock(monkeypatch):
    """Both buses stamp records from one fixed wall clock, so fetched
    message sets (timestamp and CRC) are the same bytes."""
    monkeypatch.setattr(jbus, "time", FIXED_CLOCK)
    monkeypatch.setattr(tbus, "time", FIXED_CLOCK)


async def _w(aw, timeout: float = STEP):
    return await asyncio.wait_for(aw, timeout)


def _s(v):
    if v is None:
        return struct.pack(">h", -1)
    b = v.encode()
    return struct.pack(">h", len(b)) + b


def _b(v):
    if v is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(v)) + v


def _request(api_key: int, version: int, corr: int, body: bytes) -> bytes:
    req = struct.pack(">hhi", api_key, version, corr) + _s("swx-test") + body
    return struct.pack(">i", len(req)) + req


def _mset(entries) -> bytes:
    """A classic magic-1 MessageSet built here, independent of either
    package: entries are (key, value, attributes)."""
    out = bytearray()
    for key, value, attrs in entries:
        body = struct.pack(">bbq", 1, attrs, 0) + _b(key) + _b(value)
        msg = struct.pack(">I", zlib.crc32(body)) + body
        out += struct.pack(">qi", 0, len(msg)) + msg
    return bytes(out)


def _produce(topic: str, pid: int, mset: bytes, acks: int = 1) -> bytes:
    return (struct.pack(">hi", acks, 5000) + struct.pack(">i", 1) + _s(topic)
            + struct.pack(">i", 1) + struct.pack(">i", pid) + _b(mset))


def _fetch(topic: str, pid: int, offset: int, max_wait_ms: int = 0,
           min_bytes: int = 0, max_bytes: int = 1 << 20) -> bytes:
    return (struct.pack(">iii", -1, max_wait_ms, min_bytes)
            + struct.pack(">i", 1) + _s(topic) + struct.pack(">i", 1)
            + struct.pack(">iqi", pid, offset, max_bytes))


def _list_offsets(topic: str, pid: int, ts: int, max_n: int = 1) -> bytes:
    return (struct.pack(">i", -1) + struct.pack(">i", 1) + _s(topic)
            + struct.pack(">i", 1) + struct.pack(">iqi", pid, ts, max_n))


def _metadata(*topics) -> bytes:
    return struct.pack(">i", len(topics)) + b"".join(_s(t) for t in topics)


def _commit(group: str, topic: str, pid: int, offset: int) -> bytes:
    return (_s(group) + struct.pack(">i", 1) + _s(topic) + struct.pack(">i", 1)
            + struct.pack(">iq", pid, offset) + _s(""))


def _offset_fetch(group: str, topic: str, *pids) -> bytes:
    return (_s(group) + struct.pack(">i", 1) + _s(topic)
            + struct.pack(">i", len(pids))
            + b"".join(struct.pack(">i", p) for p in pids))


def _encoded_batch(n: int, offset: float = 0.0) -> bytes:
    """A measurement batch's codec bytes, encoded once by the JAX
    package (the context stamps its creation time, so both endpoints
    must get the same bytes, not two encodings)."""
    b = jbatch.MeasurementBatch(
        jbatch.BatchContext(tenant_id="acme", source="kafka-parity"),
        np.arange(n, dtype=np.uint32), np.zeros(n, np.uint16),
        np.arange(n, dtype=np.float32) + offset, np.full(n, 77.0))
    return jcodec.encode(b)


BATCHES = {(n, off): _encoded_batch(n, off)
           for n, off in ((3, 0.0), (3, 10.0), (4, 0.0), (5, 0.0),
                          (20, 0.0), (40, 0.0))}


def _batch(n: int, offset: float = 0.0) -> bytes:
    return BATCHES[(n, offset)]


class Client:
    def __init__(self, ep):
        self.ep = ep
        self.corr = 0
        self.log: list[tuple[str, bytes]] = []

    async def open(self):
        self.reader, self.writer = await _w(asyncio.open_connection(
            "127.0.0.1", self.ep.port))

    def _norm(self, data: bytes) -> bytes:
        return data.replace(self.ep._broker_entry(), BROKER)

    async def call(self, label: str, api_key: int, body: bytes,
                   version: int = 0, answered: bool = True) -> None:
        self.corr += 1
        self.writer.write(_request(api_key, version, self.corr, body))
        await _w(self.writer.drain())
        if answered:
            size = struct.unpack(">i", await _w(self.reader.readexactly(4)))[0]
            self.log.append((label, self._norm(
                await _w(self.reader.readexactly(size)))))

    async def eof(self, label: str) -> None:
        if self.writer.can_write_eof():
            self.writer.write_eof()
        self.log.append((label, self._norm(await _w(self.reader.read()))))
        self.writer.close()


async def _endpoint(pkg, **kw):
    bus = pkg.bus.EventBus(default_partitions=2)
    await _w(bus.initialize())
    await _w(bus.start())
    ep = pkg.kafka.KafkaEndpoint(bus, **kw)
    await _w(ep.start())
    return bus, ep


async def _close(bus, ep):
    await _w(ep.stop())
    await _w(bus.stop())


async def request_set(pkg) -> dict:
    bus, ep = await _endpoint(pkg)
    c = Client(ep)
    try:
        await c.open()
        await c.call("api-versions", 18, b"")
        await c.call("api-versions-v3", 18, b"", version=3)
        await c.call("metadata-empty", 3, _metadata())
        await c.call("metadata-auto-create", 3, _metadata("telemetry", "t2"))
        await c.call("produce-v0", 0, _produce("telemetry", 0, _mset([
            (None, _batch(4), 0), (b"gw-0", _batch(3, 10.0), 0),
            (b"k", b"foreign-bytes", 0), (None, None, 0)])))
        await c.call("produce-v1", 0, _produce("telemetry", 1, _mset([
            (b"gw-1", _batch(5), 0)])), version=1)
        await c.call("produce-bad-partition", 0, _produce(
            "telemetry", 5, _mset([(None, b"x", 0)])))
        await c.call("produce-compressed", 0, _produce(
            "telemetry", 0, _mset([(None, b"gzipped-blob", 1)])))
        await c.call("produce-acks0", 0, _produce("t2", 0, _mset([
            (None, b"fire-and-forget", 0)]), acks=0), answered=False)
        await c.call("metadata-all", 3, _metadata())
        await c.call("fetch-p0", 1, _fetch("telemetry", 0, 0))
        await c.call("fetch-p0-from-2", 1, _fetch("telemetry", 0, 2))
        await c.call("fetch-p0-small", 1, _fetch("telemetry", 0, 0,
                                                 max_bytes=1))
        await c.call("fetch-p1", 1, _fetch("telemetry", 1, 0))
        await c.call("fetch-t2", 1, _fetch("t2", 0, 0))
        await c.call("fetch-out-of-range", 1, _fetch("telemetry", 0, 99))
        await c.call("fetch-long-poll-empty", 1, _fetch(
            "t2", 1, 0, max_wait_ms=30, min_bytes=1))
        for label, ts, n in (("earliest", -2, 1), ("latest", -1, 1),
                             ("at-time", 1_700_000_000_000, 1),
                             ("after-all", 1_800_000_000_000, 1),
                             ("none-asked", -1, 0)):
            await c.call(f"list-offsets-{label}", 2,
                         _list_offsets("telemetry", 0, ts, n))
        await c.call("find-coordinator", 10, _s("g"))
        await c.call("commit", 8, _commit("g", "telemetry", 0, 2))
        await c.call("commit-lower", 8, _commit("g", "telemetry", 0, 1))
        await c.call("commit-zero", 8, _commit("g", "t2", 0, 0))
        await c.call("offset-fetch", 9, _offset_fetch("g", "telemetry", 0, 1))
        await c.call("offset-fetch-t2", 9, _offset_fetch("g", "t2", 0))
        # an in-process consumer of the group starts at the wire commit
        consumer = bus.subscribe("telemetry", group="g")
        seen = [(r.partition, r.offset) for r in consumer.poll_nowait()]
        consumer.close()
        # a served API at a version it does not serve: connection dropped
        await c.call("metadata-v1", 3, _metadata(), version=1,
                     answered=False)
        await c.eof("dropped")
        c2 = Client(ep)
        await c2.open()
        await c2.call("unknown-api", 4, b"", answered=False)
        await c2.eof("dropped")
        return {"log": c.log + c2.log, "seen": seen,
                "ends": {t: bus.end_offsets(t) for t in bus.topic_names()},
                "counts": (ep.produced, ep.malformed)}
    finally:
        await _close(bus, ep)


async def throttle(pkg) -> dict:
    naming = pkg.bus.TopicNaming("flowk")
    fc = pkg.flow.FlowController(pkg.config.InstanceSettings())
    fc.set_quota("t1", rate=0.001, burst=10.0)
    bus, ep = await _endpoint(pkg, flow=fc, naming=naming)
    topic = naming.tenant_topic("t1", "event-source-decoded-events")
    c = Client(ep)
    try:
        await c.open()
        await c.call("within", 0, _produce(topic, 0, _mset([
            (None, _batch(5), 0)])), version=1)
        # over quota: accepted all the same, with a throttle hint
        await c.call("over", 0, _produce(topic, 1, _mset([
            (None, _batch(20), 0), (None, b"raw", 0)])), version=1)
        await c.call("over-v0", 0, _produce(topic, 0, _mset([
            (None, _batch(20), 0)])))
        await c.call("plain-topic", 0, _produce("plain", 0, _mset([
            (None, _batch(40), 0)])), version=1)
        return {"log": c.log, "ends": bus.end_offsets(topic),
                "throttled": ep.throttled}
    finally:
        await _close(bus, ep)


def _mutate(rng, valid: bytes, kind: int) -> bytes:
    """One seeded hostile request from a valid one: random garbage,
    a truncation, byte flips past the api key, or a lying size."""
    if kind == 0:
        blob = bytes(rng.integers(0, 256, int(rng.integers(4, 64)),
                                  dtype=np.uint8))
        return struct.pack(">i", len(blob)) + blob
    if kind == 1:
        return valid[:int(rng.integers(1, len(valid)))]
    if kind == 2:
        b = bytearray(valid)
        for pos in rng.integers(6, len(b), int(rng.integers(1, 5))):
            b[pos] = int(rng.integers(0, 256))
        return bytes(b)
    return struct.pack(">i", int(rng.choice([1 << 30, -5, 3, 0]))) \
        + b"xxxxxxxx"


async def fuzz(pkg) -> dict:
    bus, ep = await _endpoint(pkg)
    rng = np.random.default_rng(16)
    # Fetch is left out of the mutated set: a mutated max_wait could
    # park a request for up to 30 s
    valid = [_request(18, 0, 1, b""), _request(3, 0, 2, _metadata("fz")),
             _request(2, 0, 3, _list_offsets("fz", 0, -1)),
             _request(0, 0, 4, _produce("fz", 0, _mset([(b"k", b"v", 0)]))),
             _request(0, 1, 5, _produce("fz", 1, _mset([(None, _batch(3),
                                                          0)]))),
             _request(8, 0, 6, _commit("g", "fz", 0, 1)),
             _request(9, 0, 7, _offset_fetch("g", "fz", 0))]
    frames = [_mutate(rng, valid[i % len(valid)], i % 4)
              for i in range(FUZZ_FRAMES)]
    log = []
    try:
        for frame in frames:
            c = Client(ep)
            await c.open()
            c.writer.write(frame)
            await c.eof("fuzz")
            log += c.log
        c = Client(ep)
        await c.open()
        await c.call("after", 18, b"")
        await c.call("after-fetch", 1, _fetch("fz", 0, 0))
        log += c.log
        return {"log": log, "malformed": ep.malformed,
                "topics": bus.topic_names()}
    finally:
        await _close(bus, ep)


@pytest.mark.parametrize("conversation", [request_set, throttle, fuzz],
                         ids=["request-set", "throttle", "fuzz"])
def test_endpoint_matches_the_reference_byte_for_byte(run, fixed_clock,
                                                       conversation):
    want = run(_w(conversation(JAX), 120.0))
    got = run(_w(conversation(PORT), 120.0))
    assert len(got["log"]) == len(want["log"])
    for (gl, gb), (wl, wb) in zip(got["log"], want["log"]):
        assert gl == wl and gb == wb, (gl, gb[:80], wb[:80])
    for key in want:
        if key != "log":
            assert got[key] == want[key], key
    if conversation is throttle:
        # over quota: records accepted, the v1 response carries the hint
        over = dict(want["log"])["over"]
        assert struct.unpack(">i", over[-4:])[0] > 0
        within = dict(want["log"])["within"]
        assert struct.unpack(">i", within[-4:])[0] == 0
        assert sum(want["ends"]) == 4
    if conversation is request_set:
        assert want["seen"] == [(0, 2), (0, 3), (1, 0)]
    if conversation is fuzz:
        assert want["malformed"] > 0
        assert dict(want["log"])["after"][4:6] == b"\x00\x00"


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-encoded-to-port", "port-encoded-to-jax"])
def test_fetch_reads_back_the_other_packages_produce(run, writer, reader):
    """A produce encoded by one package (its codec, its message-set
    encoder) into the other package's endpoint; that endpoint's Fetch
    returns the records, which the writer's codec decodes to the same
    batch."""

    async def main():
        b = writer.batch.MeasurementBatch(
            writer.batch.BatchContext(tenant_id="acme", source="x"),
            np.arange(6, dtype=np.uint32), np.ones(6, np.uint16),
            np.linspace(0, 1, 6, dtype=np.float32), np.full(6, 5.0))
        mset = writer.kafka.encode_message_set(
            [(0, b"gw-3", writer.codec.encode(b), 0), (1, None, b"raw", 0)])
        bus, ep = await _endpoint(reader)
        c = Client(ep)
        try:
            await c.open()
            await c.call("produce", 0, _produce("x", 0, mset))
            await c.call("fetch", 1, _fetch("x", 0, 0))
        finally:
            await _close(bus, ep)
        produced = c.log[0][1]
        assert struct.unpack_from(">h", produced, len(produced) - 10)[0] == 0
        fetched = memoryview(c.log[1][1])
        off = 4 + 4 + 2 + 1 + 4 + 4 + 2 + 8
        size = struct.unpack_from(">i", fetched, off)[0]
        msgs = writer.kafka.decode_message_set(fetched[off + 4:off + 4 + size])
        assert [k for k, _ in msgs] == [b"gw-3", None]
        back = writer.codec.decode(msgs[0][1])
        assert type(back).__name__ == "MeasurementBatch"
        for name in ("device_index", "mtype", "value", "ts"):
            np.testing.assert_array_equal(getattr(back, name),
                                          getattr(b, name))
        assert back.ctx.source == "x"
        assert msgs[1][1] == b"raw"

    run(main())
