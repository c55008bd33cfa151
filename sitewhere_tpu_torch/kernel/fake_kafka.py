"""In-memory stand-in for the aiokafka surface the Kafka adapter uses.

The real adapter (kernel/kafka.py) was previously dead code in this
image: no aiokafka package, no broker, so the bus contract suite skipped
its rows and the adapter's logic never executed. This module fakes the
*client library*, not the bus — `KafkaEventBus`/`KafkaBusConsumer` run
their real serializer wiring, group/commit bookkeeping, and poll loops
against it, so the adapter's code paths (codec round trips through
bytes, TopicPartition maps, commit-offset dicts, lazy consumer start,
rebalance on join/leave) are exercised in-process. Real-broker runs
still activate via SWX_KAFKA_BOOTSTRAP (tests/test_bus_contract.py).

Faked semantics (the subset the adapter + contract tests rely on):
- topics with N partitions; producers hash keys (or round-robin) like
  the real default partitioner — one key → one partition → FIFO;
- consumer groups: range assignment over members, rebalance on
  join/leave, committed offsets per (group, topic, partition);
- `auto_offset_reset="earliest"` for uncommitted groups;
- `getmany` long-polls: it wakes on produce, not only on timeout;
- values/keys cross as BYTES through the configured (de)serializers —
  the codec round trip is real.

Brokers are keyed by bootstrap string: two clients with one bootstrap
share state (a producer and consumers see the same logs); distinct
bootstraps are isolated (tests use a unique name per case).
"""

from __future__ import annotations

import asyncio
import itertools
import time
import zlib
from dataclasses import dataclass
from typing import Any, Optional

DEFAULT_PARTITIONS = 4


@dataclass(frozen=True)
class TopicPartition:
    topic: str
    partition: int


@dataclass(frozen=True)
class RecordMetadata:
    topic: str
    partition: int
    offset: int


@dataclass(frozen=True)
class ConsumerRecord:
    topic: str
    partition: int
    offset: int
    key: Any
    value: Any
    timestamp: int  # ms, like Kafka


class _Broker:
    """Shared per-bootstrap state: logs + group coordination."""

    def __init__(self) -> None:
        # topic -> [partition logs]; log entries: (key_bytes, value_bytes, ts_ms)
        self.topics: dict[str, list[list[tuple]]] = {}
        # (group, topic, partition) -> committed offset
        self.committed: dict[tuple[str, str, int], int] = {}
        self.groups: dict[str, list["AIOKafkaConsumer"]] = {}
        self.waiters: set[asyncio.Event] = set()
        self._rr = itertools.count()

    def topic(self, name: str) -> list[list[tuple]]:
        if name not in self.topics:
            self.topics[name] = [[] for _ in range(DEFAULT_PARTITIONS)]
        return self.topics[name]

    def notify(self) -> None:
        for w in self.waiters:
            w.set()

    def rebalance(self, group: str) -> None:
        members = self.groups.get(group, [])
        for m in members:
            m._assignment = set()
            m._positions = {}
        for t in sorted({t for m in members for t in m._sub_topics}):
            subs = [m for m in members if t in m._sub_topics]
            for p in range(len(self.topic(t))):
                subs[p % len(subs)]._assignment.add(TopicPartition(t, p))
        self.notify()


_BROKERS: dict[str, _Broker] = {}


def _broker(bootstrap: str) -> _Broker:
    return _BROKERS.setdefault(bootstrap, _Broker())


def reset(bootstrap: Optional[str] = None) -> None:
    """Drop broker state (tests)."""
    if bootstrap is None:
        _BROKERS.clear()
    else:
        _BROKERS.pop(bootstrap, None)


class AIOKafkaProducer:
    def __init__(self, *, bootstrap_servers: str, client_id: str = "",
                 value_serializer=None, key_serializer=None):
        self._broker = _broker(bootstrap_servers)
        self.client_id = client_id
        self._value_ser = value_serializer or (lambda v: v)
        self._key_ser = key_serializer or (lambda k: k)
        self._started = False

    async def start(self) -> None:
        self._started = True

    async def stop(self) -> None:
        self._started = False

    async def send_and_wait(self, topic: str, value: Any, *,
                            key: Any = None,
                            partition: Optional[int] = None
                            ) -> RecordMetadata:
        if not self._started:
            raise RuntimeError("producer not started")
        logs = self._broker.topic(topic)
        kb = self._key_ser(key)
        vb = self._value_ser(value)
        if partition is None:
            if kb is None:
                partition = next(self._broker._rr) % len(logs)
            else:
                partition = zlib.crc32(kb) % len(logs)
        log = logs[partition]
        offset = len(log)
        log.append((kb, vb, int(time.time() * 1000)))
        self._broker.notify()
        return RecordMetadata(topic, partition, offset)


class AIOKafkaConsumer:
    def __init__(self, *topics: str, bootstrap_servers: str,
                 group_id: Optional[str] = None, client_id: str = "",
                 enable_auto_commit: bool = True,
                 auto_offset_reset: str = "latest",
                 value_deserializer=None, key_deserializer=None):
        self._broker = _broker(bootstrap_servers)
        self._sub_topics = list(topics)
        self.group = group_id or f"anon-{client_id}"
        self._reset = auto_offset_reset
        self._value_de = value_deserializer or (lambda v: v)
        self._key_de = key_deserializer or (lambda k: k)
        self._assignment: set[TopicPartition] = set()
        self._positions: dict[TopicPartition, int] = {}
        self._started = False

    async def start(self) -> None:
        for t in self._sub_topics:
            self._broker.topic(t)
        members = self._broker.groups.setdefault(self.group, [])
        members.append(self)
        self._broker.rebalance(self.group)
        self._started = True

    async def stop(self) -> None:
        members = self._broker.groups.get(self.group, [])
        if self in members:
            members.remove(self)
            self._broker.rebalance(self.group)
        self._started = False

    def assignment(self) -> set[TopicPartition]:
        return set(self._assignment)

    def _pos(self, tp: TopicPartition) -> int:
        pos = self._positions.get(tp)
        if pos is None:
            pos = self._broker.committed.get(
                (self.group, tp.topic, tp.partition))
            if pos is None:
                log = self._broker.topic(tp.topic)[tp.partition]
                pos = 0 if self._reset == "earliest" else len(log)
            self._positions[tp] = pos
        return pos

    async def position(self, tp: TopicPartition) -> int:
        return self._pos(tp)

    def _drain(self, max_records: int) -> dict:
        out: dict[TopicPartition, list[ConsumerRecord]] = {}
        n = 0
        for tp in sorted(self._assignment,
                         key=lambda t: (t.topic, t.partition)):
            if n >= max_records:
                break
            log = self._broker.topic(tp.topic)[tp.partition]
            pos = self._pos(tp)
            take = min(len(log) - pos, max_records - n)
            if take <= 0:
                continue
            out[tp] = [
                ConsumerRecord(tp.topic, tp.partition, pos + i,
                               self._key_de(log[pos + i][0]),
                               self._value_de(log[pos + i][1]),
                               log[pos + i][2])
                for i in range(take)]
            self._positions[tp] = pos + take
            n += take
        return out

    async def getmany(self, *partitions, timeout_ms: int = 0,
                      max_records: Optional[int] = None) -> dict:
        max_records = max_records or 512
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_ms / 1000.0
        await asyncio.sleep(0)  # yield like a network client would
        while True:
            out = self._drain(max_records)
            remaining = deadline - loop.time()
            if out or remaining <= 0:
                return out
            ev = asyncio.Event()
            self._broker.waiters.add(ev)
            try:
                await asyncio.wait_for(ev.wait(), remaining)
            except asyncio.TimeoutError:
                pass
            finally:
                self._broker.waiters.discard(ev)

    async def commit(self, offsets: Optional[dict] = None) -> None:
        src = offsets if offsets is not None else dict(self._positions)
        for tp, off in src.items():
            key = (self.group, tp.topic, tp.partition)
            if off > self._broker.committed.get(key, 0):
                self._broker.committed[key] = off

    async def seek_to_beginning(self, *partitions) -> None:
        for tp in (partitions or self._assignment):
            self._positions[tp] = 0
