"""outbound-connectors service (reference: service-outbound-connectors,
[SURVEY.md §2.2]): fan persisted/enriched events out to external systems
with per-connector filtering.

The reference ships MQTT/Solr/AzureEventHub/AmazonSQS/InitialState/dweet/
Groovy connectors; the capability surface here is the pluggable connector
registry + filter chain. Built-ins:

- `memory`: bounded in-proc sink (test double / recent-events buffer)
- `jsonl`: append JSON-lines to a file (the generic external-system
  bridge; anything that tails a file or a named pipe can consume it)
- `topic`: republish (optionally filtered) onto another bus topic —
  composition primitive for custom pipelines
- `callable`: wrap any async function (the Groovy-connector analog)
- `webhook`: HTTP POST JSON to an external endpoint (dependency-free
  asyncio HTTP/1.1 client) with retry/backoff; exhausted retries
  dead-letter the record to a bus topic — the
  InitialState/dweet/HTTP-bridge analog, and the generic "push to any
  external system" connector
- `mqtt`: republish JSON out through the tenant's MQTT broker endpoint
  (services/mqtt.py fan-out, optionally retained) — external
  subscribers (dashboards, SCADA bridges) receive enriched/scored
  events live, the MqttOutboundConnector analog

Filters (reference: IDeviceEventFilter): event-kind allowlist, device
allowlist (by index range or explicit set), score threshold for
ScoredBatch records. Filters compose with AND semantics.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Awaitable, Callable, Optional

import numpy as np

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.batch import (
    AlertBatch,
    LocationBatch,
    MeasurementBatch,
    ScoredBatch,
)
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.kernel.egresslane import egress_lanes
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine

logger = logging.getLogger(__name__)


def _kind(value) -> str:
    if isinstance(value, MeasurementBatch):
        return "measurements"
    if isinstance(value, LocationBatch):
        return "locations"
    if isinstance(value, AlertBatch):
        return "alerts"
    if isinstance(value, ScoredBatch):
        return "scored"
    if isinstance(value, list):
        return "events"
    return "unknown"


class EventFilter:
    """AND-composed record filter (reference: IDeviceEventFilter)."""

    def __init__(self, kinds: Optional[list[str]] = None,
                 device_indices: Optional[list[int]] = None,
                 min_score: Optional[float] = None):
        self.kinds = set(kinds) if kinds else None
        self.devices = set(device_indices) if device_indices else None
        self.min_score = min_score

    def apply(self, value):
        """Returns the (possibly narrowed) record, or None to drop it."""
        if self.kinds is not None and _kind(value) not in self.kinds:
            return None
        if self.devices is not None and hasattr(value, "device_index"):
            mask = np.isin(value.device_index, list(self.devices))
            if not mask.any():
                return None
            if not mask.all() and hasattr(value, "select"):
                value = value.select(mask)
        if self.min_score is not None and isinstance(value, ScoredBatch):
            mask = value.score >= self.min_score
            if not mask.any():
                return None
            value = value.select(mask)  # preserves total_scored
        return value


def record_to_jsonable(value) -> dict:
    """Wire representation for external sinks."""
    kind = _kind(value)
    out: dict = {"kind": kind, "exported_at": time.time()}
    if isinstance(value, (MeasurementBatch, LocationBatch, ScoredBatch, AlertBatch)):
        out["count"] = len(value)
        out["device_index"] = value.device_index.tolist()
        if isinstance(value, MeasurementBatch):
            out["value"] = value.value.tolist()
            out["ts"] = value.ts.tolist()
        elif isinstance(value, LocationBatch):
            out["lat"] = value.latitude.tolist()
            out["lon"] = value.longitude.tolist()
        elif isinstance(value, ScoredBatch):
            out["score"] = [round(float(s), 4) for s in value.score]
            out["is_anomaly"] = value.is_anomaly.tolist()
        elif isinstance(value, AlertBatch):
            out["level"] = value.level.tolist()
            out["type"] = list(value.type)
            out["message"] = list(value.message)
    elif isinstance(value, list):
        from sitewhere_tpu_torch.domain.events import event_to_dict

        out["events"] = [event_to_dict(ev) for ev in value]
    return out


class Connector:
    """Base connector: filter + sink. Subclass or use the built-ins."""

    def __init__(self, name: str, filter: Optional[EventFilter] = None):
        self.name = name
        self.filter = filter or EventFilter()

    async def process(self, value) -> None:
        narrowed = self.filter.apply(value)
        if narrowed is not None:
            await self.sink(narrowed)

    async def sink(self, value) -> None:  # pragma: no cover - override
        raise NotImplementedError

    def close(self) -> None:
        """Release held resources (files, sockets). Called on REST
        detach and at engine stop; base is a no-op."""


class MemoryConnector(Connector):
    def __init__(self, name: str, filter: Optional[EventFilter] = None,
                 retention: int = 1000):
        super().__init__(name, filter)
        self.records: list = []
        self.retention = retention

    async def sink(self, value) -> None:
        self.records.append(value)
        if len(self.records) > self.retention:
            del self.records[: len(self.records) - self.retention]


class JsonlConnector(Connector):
    def __init__(self, name: str, path: str,
                 filter: Optional[EventFilter] = None):
        super().__init__(name, filter)
        self.path = path
        self._fh = open(path, "a", buffering=1)

    async def sink(self, value) -> None:
        self._fh.write(json.dumps(record_to_jsonable(value)) + "\n")

    def close(self) -> None:
        self._fh.close()


class TopicConnector(Connector):
    def __init__(self, name: str, bus, topic: str,
                 filter: Optional[EventFilter] = None):
        super().__init__(name, filter)
        self.bus = bus
        self.topic = topic

    async def sink(self, value) -> None:
        await self.bus.produce(self.topic, value, key=self.name)


class CallableConnector(Connector):
    def __init__(self, name: str, fn: Callable[[object], Awaitable[None]],
                 filter: Optional[EventFilter] = None):
        super().__init__(name, filter)
        self.fn = fn

    async def sink(self, value) -> None:
        await self.fn(value)


class WebhookConnector(Connector):
    """POST each (filtered) record as JSON to an external HTTP endpoint.

    Dependency-free asyncio HTTP/1.1 client (http:// only — this image
    terminates TLS at the edge; an https URL raises at config time, not
    silently downgrades). Failures retry with exponential backoff; a
    record that exhausts its retries is DEAD-LETTERED to a bus topic so
    an operator can replay it — never silently dropped."""

    def __init__(self, name: str, url: str, bus, dead_letter_topic: str,
                 filter: Optional[EventFilter] = None, retries: int = 3,
                 backoff_s: float = 0.2, timeout_s: float = 10.0):
        super().__init__(name, filter)
        from sitewhere_tpu_torch.utils.http import parse_http_url

        self.url = url
        self.host, self.port, self.path = parse_http_url(
            url, "webhook connector")
        self.bus = bus
        self.dead_letter_topic = dead_letter_topic
        self.retries = max(1, retries)
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.delivered = 0
        self.dead_lettered = 0

    async def sink(self, value) -> None:
        from sitewhere_tpu_torch.utils.http import http_post_retrying

        body = json.dumps(record_to_jsonable(value)).encode()
        ok, last = await http_post_retrying(
            self.host, self.port, self.path, body,
            retries=self.retries, backoff_s=self.backoff_s,
            timeout_s=self.timeout_s)
        if ok:
            self.delivered += 1
            return
        self.dead_lettered += 1
        logger.warning("webhook %s → %s failed after %d attempts (%s); "
                       "dead-lettering", self.name, self.url, self.retries,
                       last)
        await self.bus.produce(self.dead_letter_topic, value, key=self.name)


class ConnectorApi:
    """Bindings handed to connector scripts (reference analog: the
    Groovy connector's binding set): bus republish, per-script
    persistent state, and a logger — enough to build counters,
    transforms, and bridges without platform access."""

    def __init__(self, engine: "OutboundConnectorsEngine", name: str):
        self._engine = engine
        self.tenant_id = engine.tenant_id
        self.state: dict = {}
        self.log = logging.getLogger(f"swx.connector-script.{name}")

    async def produce(self, topic: str, value) -> None:
        await self._engine.runtime.bus.produce(topic, value)


class ScriptedConnector(Connector):
    """Tenant-scripted outbound connector (reference analog:
    GroovyEventConnector beside the Groovy decoder/rule scripts): the
    operator uploads a python script defining

        async def sink(record: dict, api) -> None

    `record` is the jsonable view of the enriched/scored record (same
    shape the jsonl/webhook connectors emit); `api` is a ConnectorApi.
    The manager is consulted per record, so a script upload hot-swaps
    the connector mid-stream; per-connector `api.state` survives
    reloads (versioned logic, persistent counters)."""

    def __init__(self, name: str, script_name: str, engine,
                 filter: Optional[EventFilter] = None):
        super().__init__(name, filter)
        self.script_name = script_name
        self._engine = engine
        self.api = ConnectorApi(engine, name)

    async def sink(self, value) -> None:
        fn = self._engine.connector_scripts.hook(self.script_name)
        await fn(record_to_jsonable(value), self.api)


class MqttRepublishConnector(Connector):
    """Republish (filtered) records as JSON out through the tenant's
    MQTT broker endpoint: one PUBLISH on `<topic_prefix><kind>` per
    record, fanned out live to matching external subscribers, optionally
    retained so late subscribers see the latest record per kind."""

    def __init__(self, name: str, listener_fn, topic_prefix: str = "swx/outbound/",
                 filter: Optional[EventFilter] = None, retain: bool = False):
        super().__init__(name, filter)
        # lazily resolved: the MQTT endpoint (event-sources) may not be
        # started when connector config is parsed
        self.listener_fn = listener_fn  # () -> services.mqtt.MqttListener
        self.topic_prefix = topic_prefix
        self.retain = retain
        self.published = 0

    async def sink(self, value) -> None:
        listener = self.listener_fn()
        payload = json.dumps(record_to_jsonable(value)).encode()
        topic = f"{self.topic_prefix}{_kind(value)}"
        self.published += await listener.publish(topic, payload,
                                                 retain=self.retain)


class OutboundConnectorsEngine(TenantEngine):
    """(reference: OutboundConnectorsManager)"""

    def __init__(self, service: "OutboundConnectorsService", tenant: TenantConfig):
        super().__init__(service, tenant)
        self.connectors: dict[str, Connector] = {}
        cfg = tenant.section("outbound-connectors", {})
        # connector scripts (reference: GroovyEventConnector): uploaded
        # per tenant, hot-reloadable, bound by connectors with
        # {"kind": "script", "script": "<name>"}
        from sitewhere_tpu_torch.kernel.scripting import ScriptManager

        self.connector_scripts = ScriptManager(
            self.tenant_id, entrypoint="sink", require_async=True)
        for name, source in cfg.get("scripts", {}).items():
            self.connector_scripts.put(name, source)
        for c in cfg.get("connectors", []):
            self.add_connector_config(c)
        # `egress: {lanes: N}` (kernel/egresslane.py) shards the fan-out
        # consumer: N loops in the one `{tenant}.outbound-connectors`
        # group split the enriched + scored topics' partitions
        self.managers = [
            OutboundManager(self, shard=i)
            for i in range(egress_lanes(tenant, self.runtime))]
        self.manager = self.managers[0]
        for m in self.managers:
            self.add_child(m)

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        # engine-level close (was per-manager): with sharded managers,
        # exactly ONE owner releases connector resources
        for connector in self.connectors.values():
            connector.close()

    def put_connector_script(self, name: str, source: str):
        """Upload/hot-reload a connector script (live connectors bound
        to it pick the new version up on their next record)."""
        return self.connector_scripts.put(name, source)

    def delete_connector_script(self, name: str):
        """Delete a connector script — refused while a live connector
        still references it."""
        users = [c.name for c in self.connectors.values()
                 if isinstance(c, ScriptedConnector)
                 and c.script_name == name]
        if users:
            raise ValueError(
                f"connector script {name!r} is in use by connector(s) "
                f"{users}; remove them first")
        return self.connector_scripts.delete(name)

    def add_connector_config(self, c: dict) -> Connector:
        filt = EventFilter(kinds=c.get("kinds"),
                          device_indices=c.get("devices"),
                          min_score=c.get("min_score"))
        kind = c.get("kind", "memory")
        name = c.get("name")
        if name and name in self.connectors:
            # a silent replace would orphan the old connector's
            # resources and lose its config — refuse at every call
            # site, not just the REST pre-check
            raise ValueError(f"connector {name!r} already exists")
        if not name:  # generated names must never collide/replace
            i = len(self.connectors)
            while f"{kind}-{i}" in self.connectors:
                i += 1
            name = f"{kind}-{i}"
        if kind == "memory":
            conn = MemoryConnector(name, filt, retention=c.get("retention", 1000))
        elif kind == "jsonl":
            conn = JsonlConnector(name, c["path"], filt)
        elif kind == "topic":
            conn = TopicConnector(name, self.runtime.bus, c["topic"], filt)
        elif kind == "webhook":
            conn = WebhookConnector(
                name, c["url"], self.runtime.bus,
                c.get("dead_letter_topic")
                or self.tenant_topic("outbound-dead-letter"),
                filt, retries=c.get("retries", 3),
                backoff_s=c.get("backoff_s", 0.2),
                timeout_s=c.get("timeout_s", 10.0))
        elif kind == "mqtt":
            receiver_name = c.get("receiver", "mqtt")
            if "event-sources" not in self.runtime.services:
                # split deployment with event-sources in a peer process:
                # the republish path needs the LOCAL broker listener
                # object — fail at config time, not per record at sink
                raise ValueError(
                    "mqtt outbound connector needs event-sources hosted "
                    "in THIS process (its broker listener is used "
                    "directly); colocate the services or use a webhook/"
                    "topic connector instead")

            def listener_fn(receiver_name=receiver_name):
                return (self.runtime.api("event-sources")
                        .engine(self.tenant_id)
                        .receiver(receiver_name).listener)

            conn = MqttRepublishConnector(
                name, listener_fn,
                topic_prefix=c.get("topic_prefix", "swx/outbound/"),
                filter=filt, retain=c.get("retain", False))
        elif kind == "script":
            script_name = c["script"]
            if self.connector_scripts.get(script_name) is None:
                raise ValueError(
                    f"connector references unknown script {script_name!r}"
                    " — upload it first (PUT /api/connector-scripts/"
                    f"{script_name})")
            conn = ScriptedConnector(name, script_name, self, filt)
        else:
            raise ValueError(f"unknown connector kind {kind!r}")
        self.connectors[name] = conn
        return conn

    def add_connector(self, connector: Connector) -> None:
        """Extension point for custom (e.g. MQTT) connectors."""
        self.connectors[connector.name] = connector

    def remove_connector(self, name: str) -> Connector:
        conn = self.connectors.pop(name, None)
        if conn is None:
            raise KeyError(f"unknown connector {name!r}")
        conn.close()
        return conn


class OutboundManager(BackgroundTaskComponent):
    def __init__(self, engine: OutboundConnectorsEngine, shard: int = 0):
        super().__init__("outbound-manager" if shard == 0
                         else f"outbound-manager-{shard}")
        self.engine = engine
        self.shard = shard

    async def _run(self) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        forwarded = runtime.metrics.meter("outbound.records_forwarded")
        consumer = runtime.bus.subscribe(
            [engine.tenant_topic(TopicNaming.OUTBOUND_ENRICHED),
             engine.tenant_topic(TopicNaming.SCORED_EVENTS)],
            group=f"{tenant_id}.outbound-connectors")
        # clean-handoff commit-through (same contract as the inbound
        # processor): a cancellation mid-batch must not lose a handled
        # record's commit — a redelivery would re-fire every connector
        # (webhooks, external sinks) on the same record. The finally
        # commits the handled prefix exactly.
        handled: dict[tuple[str, int], int] = {}
        try:
            while True:
                for record in await consumer.poll(max_records=64, timeout=0.5):
                    # snapshot: REST add/delete mutates the dict while
                    # process() is suspended; a live iterator would die.
                    # Connector failures stay isolated per connector (a
                    # record other connectors handled fine is not
                    # poison); anything escaping that isolation (e.g. a
                    # record the snapshot loop itself chokes on) is
                    # quarantined so the fan-out keeps draining.
                    try:
                        for connector in list(engine.connectors.values()):
                            try:
                                await connector.process(record.value)
                            except Exception:  # noqa: BLE001 - isolated
                                logger.exception("connector %s failed",
                                                 connector.name)
                        forwarded.mark(1)
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        await engine.dead_letter(record, exc, self.path)
                    # slotted-attribute reads cannot raise — bookkeeping
                    handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                consumer.commit()
        finally:
            try:
                if handled:
                    # commit the handled prefix (see above)
                    consumer.commit(dict(handled))
            except RuntimeError:
                pass
            consumer.close()


class OutboundConnectorsService(Service):
    identifier = "outbound-connectors"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> OutboundConnectorsEngine:
        return OutboundConnectorsEngine(self, tenant)
