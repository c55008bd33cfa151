"""event-management service (reference: service-event-management,
[SURVEY.md §2.2, §3.2]): persist inbound events to the event store and
republish enriched/persisted events for downstream consumers
(device-state, rule-processing/scoring, outbound-connectors).

Persistence is the columnar TelemetryStore (vectorized ring scatter); the
"enriched" record is the same columnar batch object — downstream
consumers share it zero-copy (the reference re-marshals protobuf at this
hop; that cost is deleted by design).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Sequence

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.batch import AlertBatch, LocationBatch, MeasurementBatch
from sitewhere_tpu_torch.domain.events import (
    DeviceAlert,
    DeviceCommandInvocation,
    DeviceCommandResponse,
    DeviceStateChange,
)
from sitewhere_tpu_torch.kernel.bus import FencedError, TopicNaming
from sitewhere_tpu_torch.kernel.egresslane import egress_lanes
from sitewhere_tpu_torch.kernel.fastlane import produce_settled
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine
from sitewhere_tpu_torch.history import EventHistoryStore
from sitewhere_tpu_torch.persistence.durable import DurableEventLog
from sitewhere_tpu_torch.persistence.memory import InMemoryDeviceEventManagement

logger = logging.getLogger(__name__)


class _Skip(Exception):
    """Unknown record kind: logged and skipped, not dead-lettered (a
    foreign value on the inbound topic is noise, not poison)."""


class EventManagementEngine(TenantEngine):
    def __init__(self, service: "EventManagementService", tenant: TenantConfig):
        super().__init__(service, tenant)
        self.spi: InMemoryDeviceEventManagement = None  # type: ignore[assignment]
        # cold tier over the durable log (history/); None unless this
        # tenant persists to disk
        self.history_store = None
        # `egress: {lanes: N}` (kernel/egresslane.py) shards the persist
        # consumer: N loops in the one `{tenant}.event-management`
        # group split the inbound topic's partitions (per-device order
        # holds — one key, one partition, one lane)
        self.persisters = [
            EventPersister(self, shard=i)
            for i in range(egress_lanes(tenant, self.runtime))]
        self.persister = self.persisters[0]
        for p in self.persisters:
            self.add_child(p)
        self._enriched_topic = self.tenant_topic(TopicNaming.OUTBOUND_ENRICHED)

    async def _do_initialize(self, monitor) -> None:
        # device-management's engine may not be up yet (independent
        # tenant-update consumers) — wait, like the reference's ApiChannel
        cfg = self.tenant.section("event-management", {})
        dm = await self.runtime.wait_for_engine("device-management",
                                                self.tenant_id)
        durable = None
        settings = self.runtime.settings
        data_dir = cfg.get("data_dir", settings.data_dir)
        if data_dir:
            durable = DurableEventLog(
                os.path.join(data_dir, "tenants", self.tenant_id, "events"),
                segment_bytes=cfg.get("durable_segment_bytes",
                                      settings.durable_segment_bytes),
                max_segments=cfg.get("durable_max_segments",
                                     settings.durable_max_segments),
                fsync_interval_s=cfg.get("durable_fsync_interval_s",
                                         settings.durable_fsync_interval_s),
                faults=self.runtime.faults)
        # with a durable log, the store replays it here, before any
        # consumer runs
        self.spi = InMemoryDeviceEventManagement(
            dm, history=cfg.get("history", 1024),
            cold_retention=cfg.get("cold_retention", 100_000),
            durable=durable)
        if durable is None:
            return
        if durable.log._segments():
            logger.info("event-management[%s]: replayed durable log "
                        "(%d events now in store)", self.tenant_id,
                        self.spi.telemetry.total_events)
        # historical replay plane: the cold tier lives beside the
        # durable log it compacts. Maintenance runs on its own thread
        # (disk+numpy — same off-loop split as the durable writer);
        # interval 0 leaves compaction on-demand (`cli replay`, tests)
        self.history_store = EventHistoryStore(
            os.path.join(data_dir, "tenants", self.tenant_id, "history"),
            source=durable.log,
            window_s=cfg.get("history_window_s", settings.history_window_s),
            block_events=cfg.get("history_block_events",
                                 settings.history_block_events),
            metrics=self.runtime.metrics,
            faults=self.runtime.faults)
        interval = cfg.get("history_compact_interval_s",
                           settings.history_compact_interval_s)
        if interval and interval > 0:
            self.history_store.start_maintenance(float(interval))

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        loop = asyncio.get_running_loop()
        if self.history_store is not None:
            # stop the compaction thread before the durable log closes
            # under it
            await loop.run_in_executor(None, self.history_store.close)
        if self.spi is not None and self.spi.durable is not None:
            # drain + fsync the spill queue off-loop so a clean shutdown
            # loses nothing (hard kills are bounded by fsync_interval_s)
            await loop.run_in_executor(None, self.spi.durable.close)

    # -- API surface for other services / REST -----------------------------

    async def add_command_invocations(
            self, invocations: Sequence[DeviceCommandInvocation]):
        """Persist invocations and publish them (command-delivery listens)."""
        out = self.spi.add_command_invocations(invocations)
        await self.runtime.bus.produce(self._enriched_topic, list(out),
                                       fence=self.fence_token())
        return out

    async def add_alerts(self, alerts: Sequence[DeviceAlert]):
        out = self.spi.add_alerts(alerts)
        await self.runtime.bus.produce(self._enriched_topic, list(out),
                                       fence=self.fence_token())
        return out

    async def add_command_responses(
            self, responses: Sequence[DeviceCommandResponse]):
        """Persist device command responses and republish (closes the
        command round trip: invoke → deliver → respond)."""
        out = self.spi.add_command_responses(responses)
        await self.runtime.bus.produce(self._enriched_topic, list(out),
                                       fence=self.fence_token())
        return out

    async def add_state_changes(self, changes: Sequence[DeviceStateChange]):
        out = self.spi.add_state_changes(changes)
        await self.runtime.bus.produce(self._enriched_topic, list(out),
                                       fence=self.fence_token())
        return out

    def __getattr__(self, name):
        return getattr(self.spi, name)


class EventPersister(BackgroundTaskComponent):
    """Consume inbound events → persist → republish enriched."""

    def __init__(self, engine: EventManagementEngine, shard: int = 0):
        super().__init__("event-persister" if shard == 0
                         else f"event-persister-{shard}")
        self.engine = engine
        self.shard = shard

    async def _run(self) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        inbound_topic = engine.tenant_topic(TopicNaming.INBOUND_EVENTS)
        enriched_topic = engine._enriched_topic
        persisted = runtime.metrics.meter("event_management.events_persisted")
        consumer = runtime.bus.subscribe(
            inbound_topic, group=f"{tenant_id}.event-management")
        spi = engine.spi
        # clean-handoff commit-through (same contract as the inbound
        # processor): on a wire bus the enriched re-publish suspends, so
        # a release's cancel can land mid-batch AFTER a record was
        # persisted + re-published but before the round-end commit — a
        # redelivery would then store AND score those events twice. The
        # finally commits the handled prefix exactly.
        handled: dict[tuple[str, int], int] = {}
        try:
            while True:
                for record in await consumer.poll(max_records=256, timeout=0.2):
                    # poison quarantine: a batch the store rejects goes
                    # to the tenant DLQ; the persister keeps draining
                    try:
                        self._persist(record, spi, runtime, tenant_id,
                                      persisted)
                    except asyncio.CancelledError:
                        raise
                    except _Skip:
                        handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                        continue
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        await engine.dead_letter(record, exc, self.path)
                        handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                        continue
                    # the batch is already persisted: a failed enriched
                    # re-publish must NOT dead-letter it (replay would
                    # run it through the persister again and store the
                    # events twice) — count the lost enrichment instead.
                    # DLQ01-disabled for that reason: the broad handler
                    # below never raises, so the loop still survives
                    try:  # swxlint: disable=DLQ01
                        # scored-path-critical publish: cancellation
                        # inside it must not make the handled-through
                        # commit ambiguous (produce_settled marks the
                        # record handled when the frame is already on
                        # the broker's path)
                        await produce_settled(
                            runtime.bus, enriched_topic, record.value,
                            key=record.key, fence=engine.fence_token(),
                            mark=lambda r=record: handled.__setitem__(
                                (r.topic, r.partition), r.offset + 1))
                    except asyncio.CancelledError:
                        raise
                    except FencedError:
                        # ownership moved: report it (the fleet worker
                        # stops these engines) — counting it as an
                        # enrich failure would mislabel a fencing event
                        engine.fence_lost()
                    except Exception:  # noqa: BLE001 - counted, not poison
                        runtime.metrics.counter(
                            "event_management.enrich_publish_failures").inc()
                        logger.exception(
                            "event-mgmt[%s]: enriched re-publish failed; "
                            "batch persisted but not enriched", tenant_id)
                    # slotted-attribute reads cannot raise — bookkeeping
                    handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                try:
                    consumer.commit(fence=engine.fence_token())
                except FencedError:
                    engine.fence_lost()
        finally:
            try:
                if handled:
                    # commit the handled prefix (see above); fenced or
                    # evicted refusals leave the offsets to the owner
                    consumer.commit(dict(handled),
                                    fence=engine.fence_token())
            except (FencedError, RuntimeError):
                pass
            consumer.close()

    def _persist(self, record, spi, runtime, tenant_id, persisted) -> None:
        batch = record.value
        ctx = getattr(batch, "ctx", None)
        # a batch without a ctx (cold per-event objects) has no trace
        with runtime.tracer.span("event-management.persist", tenant_id,
                                 ctx.trace_id if ctx is not None else 0
                                 ) as persist:
            if isinstance(batch, MeasurementBatch):
                persisted.mark(spi.add_measurements(batch))
            elif isinstance(batch, LocationBatch):
                persisted.mark(spi.add_locations(batch))
            elif isinstance(batch, AlertBatch):
                persisted.mark(len(spi.add_alert_batch(batch)))
            elif isinstance(batch, list):  # cold per-event objects
                stored = 0
                for ev in batch:
                    if isinstance(ev, DeviceAlert):
                        spi.add_alerts([ev])
                    elif isinstance(ev, DeviceCommandResponse):
                        spi.add_command_responses([ev])
                    elif isinstance(ev, DeviceStateChange):
                        spi.add_state_changes([ev])
                    else:
                        logger.warning("event-mgmt: unpersistable cold"
                                       " event %r", type(ev))
                        continue
                    stored += 1
                persisted.mark(stored)
            else:
                logger.warning("event-mgmt: unknown record %r", type(batch))
                raise _Skip()
            persist.n_events = len(batch)


class EventManagementService(Service):
    identifier = "event-management"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> EventManagementEngine:
        return EventManagementEngine(self, tenant)

    def management(self, tenant_id: str) -> EventManagementEngine:
        return self.engine(tenant_id)  # type: ignore[return-value]
