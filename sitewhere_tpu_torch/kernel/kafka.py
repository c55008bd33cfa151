"""Real-Kafka adapter for the event bus Protocol.

SURVEY.md §5.8: "the Kafka event bus stays intact" is north-star text —
deployments that already run Kafka plug the SAME service code into a
real cluster by constructing the runtime with
`ServiceRuntime(settings, bus=KafkaEventBus("broker:9092"))`. Values
cross Kafka in the restricted wire codec (kernel/codec.py), so columnar
batches stay columnar; keys map to Kafka keys, preserving the per-key
ordering contract; consumer groups / committed offsets / rebalance are
Kafka's own.

This image has no Kafka client library (aiokafka is not baked in), so
the adapter import-gates: constructing it without aiokafka raises a
clear error unless a client module is injected. The in-repo fake
(kernel/fake_kafka.py) implements the aiokafka surface this adapter
uses, so the bus CONTRACT tests (tests/test_bus_contract.py) run the
identical suite against in-proc, wire, AND this adapter in every image;
the rows hit a real broker wherever aiokafka + `SWX_KAFKA_BOOTSTRAP`
exist.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, Iterable, Optional

from sitewhere_tpu_torch.kernel import codec
from sitewhere_tpu_torch.kernel.bus import TopicRecord

logger = logging.getLogger(__name__)

try:  # gated: not baked into this image
    import aiokafka  # type: ignore
except ImportError:  # pragma: no cover - exercised only without the lib
    aiokafka = None


class KafkaEventBus:
    """`EventBus` surface over a real Kafka cluster (aiokafka).

    `client_mod` injects the client library (default: aiokafka). The
    in-repo `kernel.fake_kafka` implements the same surface so the
    adapter's logic — serializer wiring, group/commit bookkeeping, the
    poll loop — runs and is contract-tested in images with no broker."""

    def __init__(self, bootstrap_servers: str, client_id: str = "swx", *,
                 client_mod=None):
        self._mod = client_mod if client_mod is not None else aiokafka
        if self._mod is None:
            raise RuntimeError(
                "KafkaEventBus needs the aiokafka package; this image "
                "does not bake it in — use the in-proc bus or the wire "
                "bus broker (`swx serve-bus`) instead")
        self.bootstrap = bootstrap_servers
        self.client_id = client_id
        self._producer = None
        self._consumers: list["KafkaBusConsumer"] = []
        self._bg: set = set()  # strong refs: the loop keeps only weak ones

    # lifecycle stand-ins (ServiceRuntime treats the bus as a child)
    async def initialize(self) -> None:
        self._producer = self._mod.AIOKafkaProducer(
            bootstrap_servers=self.bootstrap, client_id=self.client_id,
            value_serializer=codec.encode,
            key_serializer=lambda k: k.encode() if k else None)
        await self._producer.start()

    async def start(self) -> None:
        if self._producer is None:
            await self.initialize()

    async def stop(self) -> None:
        for consumer in list(self._consumers):
            await consumer.aclose()
        if self._bg:
            # settle in-flight fire-and-forget produces before the
            # producer goes away (each one logs its own failure)
            await asyncio.gather(*list(self._bg), return_exceptions=True)
        if self._producer is not None:
            await self._producer.stop()
            self._producer = None

    def create_topic(self, name: str, **kwargs: Any) -> None:
        pass  # broker-side auto-create / admin tooling owns topics

    async def produce(self, topic: str, value: Any, *,
                      key: Optional[str] = None,
                      partition: Optional[int] = None) -> tuple[int, int]:
        meta = await self._producer.send_and_wait(
            topic, value, key=key, partition=partition)
        return meta.partition, meta.offset

    def produce_nowait(self, topic: str, value: Any, *,
                       key: Optional[str] = None,
                       partition: Optional[int] = None) -> None:
        _spawn_logged(self._bg, self.produce(topic, value, key=key,
                                             partition=partition))

    def subscribe(self, topics: Iterable[str] | str, *, group: str,
                  name: Optional[str] = None) -> "KafkaBusConsumer":
        if isinstance(topics, str):
            topics = [topics]
        consumer = KafkaBusConsumer(self, list(topics), group,
                                    name or group)
        self._consumers.append(consumer)
        return consumer


class KafkaBusConsumer:
    """`BusConsumer` surface over aiokafka (lazy start on first poll)."""

    def __init__(self, bus: KafkaEventBus, topics: list, group: str,
                 name: str):
        self._bus = bus
        self._topics = topics
        self.group = group
        self.name = name
        self._consumer = None
        self._closed = False
        self._bg: set = set()  # strong refs: the loop keeps only weak ones

    async def _ensure(self) -> None:
        if self._consumer is None:
            self._consumer = self._bus._mod.AIOKafkaConsumer(
                *self._topics,
                bootstrap_servers=self._bus.bootstrap,
                group_id=self.group, client_id=self.name,
                enable_auto_commit=False,
                auto_offset_reset="earliest",
                value_deserializer=codec.decode,
                key_deserializer=lambda k: k.decode() if k else None)
            await self._consumer.start()

    async def poll(self, *, max_records: int = 512,
                   timeout: float = 1.0) -> list[TopicRecord]:
        if self._closed:
            return []
        await self._ensure()
        batches = await self._consumer.getmany(
            timeout_ms=int(timeout * 1000), max_records=max_records)
        out: list[TopicRecord] = []
        for tp, records in batches.items():
            for r in records:
                out.append(TopicRecord(tp.topic, tp.partition, r.offset,
                                       r.key, r.value, r.timestamp / 1e3))
        return out

    def commit(self, positions: Optional[dict] = None) -> None:
        if self._consumer is None:
            return
        if positions is not None:
            offsets = {self._bus._mod.TopicPartition(t, p): off
                       for (t, p), off in positions.items()}
            coro = self._consumer.commit(offsets)
        else:
            coro = self._consumer.commit()
        _spawn_logged(self._bg, coro)

    def snapshot_positions(self):
        return self._snapshot()

    async def _snapshot(self) -> dict:
        await self._ensure()
        out = {}
        for tp in self._consumer.assignment():
            out[(tp.topic, tp.partition)] = await self._consumer.position(tp)
        return out

    def seek_to_beginning(self) -> None:
        if self._consumer is not None:
            _spawn_logged(self._bg, self._consumer.seek_to_beginning())

    async def aclose(self) -> None:
        if not self._closed:
            self._closed = True
            if self._bg:
                # settle in-flight commits/seeks before the consumer
                # stops (each one logs its own failure)
                await asyncio.gather(*list(self._bg),
                                     return_exceptions=True)
            if self._consumer is not None:
                await self._consumer.stop()

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            if self._consumer is not None:
                _spawn_logged(self._bg, self._consumer.stop())


async def _log_failure(coro) -> None:
    try:
        await coro
    except Exception:  # noqa: BLE001 - background kafka op
        logger.exception("kafka background operation failed")


def _spawn_logged(tasks: set, coro) -> "asyncio.Task":
    """Retained fire-and-forget: the task set holds the strong reference
    the event loop does not (an unretained task can be GC'd mid-flight —
    swx lint TSK01), and the `_log_failure` wrapper retrieves the result
    so a failed background op surfaces in the log instead of nowhere."""
    task = asyncio.get_running_loop().create_task(_log_failure(coro))
    tasks.add(task)
    task.add_done_callback(tasks.discard)
    return task
