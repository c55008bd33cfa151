"""inbound-processing service (reference: service-inbound-processing,
[SURVEY.md §2.2, §3.2]): consume decoded events, validate device +
assignment, split off unregistered devices, forward for persistence.

Reference hot-loop note [SURVEY.md §3.2]: upstream pays a per-event gRPC
`getDeviceByToken` to device-management here — its latency killer. The
TPU-first replacement: decoded batches carry dense device indices, and
validation is ONE vectorized mask gather per batch against the
device-management engine's registration mask. Unknown devices are split
into the unregistered-device topic (consumed by device-registration) with
the same at-least-once semantics.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional


from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.batch import (
    LocationBatch,
    MeasurementBatch,
    RegistrationBatch,
)
from sitewhere_tpu_torch.kernel.bus import FencedError, TopicNaming
from sitewhere_tpu_torch.kernel.egresslane import egress_lanes
from sitewhere_tpu_torch.kernel.fastlane import (
    fastlane_enabled,
    produce_settled,
    validate_and_split,
)
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine

logger = logging.getLogger(__name__)


class InboundProcessingEngine(TenantEngine):
    def __init__(self, service: "InboundProcessingService", tenant: TenantConfig):
        super().__init__(service, tenant)
        # fused ingress fast lane (kernel/fastlane.py): when the tenant
        # qualifies, the rule-processing engine's FastLane owns the
        # decoded topic's consumer group and performs this engine's
        # validate/split/produce work in the same hop as the scoring
        # admit — spinning the staged consumer here too would split
        # partitions with it. Both services evaluate the same predicate
        # from config + topology, so they always agree on the lane.
        # `egress: {lanes: N}` (kernel/egresslane.py) shards the staged
        # consumer too: N loops join the one
        # `{tenant}.inbound-processing` group, splitting partitions —
        # the same lane machinery (and committed-offset resume) as the
        # fused fast lane, so the A/B compares like with like.
        self.processors: list[InboundProcessor] = []
        self.processor: Optional[InboundProcessor] = None
        if not fastlane_enabled(tenant, self.runtime):
            self.processors = [
                InboundProcessor(self, shard=i)
                for i in range(egress_lanes(tenant, self.runtime))]
            self.processor = self.processors[0]
            for p in self.processors:
                self.add_child(p)


class InboundProcessor(BackgroundTaskComponent):
    def __init__(self, engine: InboundProcessingEngine, shard: int = 0):
        super().__init__("inbound-processor" if shard == 0
                         else f"inbound-processor-{shard}")
        self.engine = engine
        self.shard = shard

    async def _run(self) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        # engines start in broadcast order across services — wait, don't race
        dm = await runtime.wait_for_engine("device-management", tenant_id)
        dm_service = runtime.services.get("device-management")
        decoded_topic = engine.tenant_topic(TopicNaming.EVENT_SOURCE_DECODED)
        inbound_topic = engine.tenant_topic(TopicNaming.INBOUND_EVENTS)
        unregistered_topic = engine.tenant_topic(TopicNaming.UNREGISTERED_DEVICES)
        metrics = runtime.metrics
        processed = metrics.meter("inbound.events_processed")
        dropped = metrics.counter("inbound.events_unregistered")
        consumer = runtime.bus.subscribe(
            decoded_topic, group=f"{tenant_id}.inbound-processing")
        flow = runtime.flow
        # clean-handoff commit-through: a cancellation (tenant release,
        # engine stop) can land at ANY await once the bus is a wire bus
        # (every produce suspends awaiting the broker ack; in-proc it
        # never does) — including mid-batch, AFTER a record's enriched
        # output was already published but BEFORE the round-end commit.
        # Without a final commit of the handled prefix, the adopter
        # redelivers that record and scores it twice (measured: the
        # wire straddle drill double-scored exactly the batch in flight
        # at the release). `handled` tracks per-partition handled-
        # through offsets; the finally commits exactly that prefix —
        # published work committed, unhandled records left for the new
        # owner (the at-least-once bound tightens to exactly-once on a
        # clean handoff, the same contract the fused lane pins).
        handled: dict[tuple[str, int], int] = {}
        try:
            while True:
                # re-resolve each round: a tenant update swaps the dm engine
                if dm_service is not None:
                    dm = dm_service.engines.get(tenant_id, dm)
                for record in await consumer.poll(max_records=256, timeout=0.2):
                    # poison quarantine: a record whose handling raises
                    # goes to the tenant DLQ (with provenance) and the
                    # loop keeps draining — one bad record must never
                    # kill the tenant's whole inbound path. Admission
                    # lives inside the wrapper too: a record whose cost
                    # estimate blows up is itself poison
                    try:
                        # weighted-fair admission (kernel/flow.py):
                        # instead of handling records FIFO off the bus,
                        # each batch is admitted through the instance's
                        # DRR scheduler — with flow_inbound_rate capped,
                        # a hog tenant's backlog drains in proportion to
                        # its weight, not its depth (uncapped instances
                        # pass through untouched)
                        if flow is not None:
                            try:
                                cost = float(len(record.value))
                            except TypeError:
                                cost = 1.0
                            await flow.admit_fair(tenant_id, max(cost, 1.0))
                        if runtime.faults is not None:
                            # acheck, not check: a delay-mode fault must
                            # suspend this coroutine, not the event loop
                            await runtime.faults.acheck("inbound.handle")
                        await self._handle(
                            record, dm, runtime, tenant_id,
                            inbound_topic, unregistered_topic,
                            processed, dropped,
                            # cancellation-unambiguous publish
                            # accounting (produce_settled): a cancel
                            # landing inside the enriched publish still
                            # marks the record handled when its frame
                            # is already on the broker's path
                            mark=lambda r=record: handled.__setitem__(
                                (r.topic, r.partition), r.offset + 1))
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        await engine.dead_letter(record, exc, self.path)
                    # slotted-attribute reads on the TopicRecord cannot
                    # raise — bookkeeping, not record handling
                    handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                try:
                    consumer.commit(fence=engine.fence_token())
                except FencedError:
                    # ownership moved (epoch fencing): offsets stay for
                    # the new owner; the fleet worker stops these engines
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

    async def _handle(self, record, dm, runtime, tenant_id, inbound_topic,
                      unregistered_topic, processed, dropped,
                      mark=None) -> None:
        engine = self.engine
        batch = record.value
        t_span = time.monotonic()
        if isinstance(batch, (MeasurementBatch, LocationBatch)):
            ctx = batch.ctx
            if getattr(ctx, "fastlane", False):
                # stale fast-lane flag: a record the fused lane handled
                # (mutating the shared ctx in the decoded-topic log) can
                # redeliver HERE after a lane toggle — left set, the rule
                # processor would skip its scoring admit and the events
                # would silently never score. The staged lane claims the
                # batch for enriched-hop admission.
                ctx.fastlane = False
            batch = await validate_and_split(batch, dm, runtime,
                                             unregistered_topic, dropped,
                                             fence=engine.fence_token())
            if len(batch):
                processed.mark(len(batch))
                # the scored-path-critical publish: cancellation inside
                # it must not make the handled-through commit ambiguous
                # (kernel/fastlane.py produce_settled)
                await produce_settled(runtime.bus, inbound_topic, batch,
                                      key=record.key,
                                      fence=engine.fence_token(),
                                      mark=mark)
            runtime.tracer.record(
                batch.ctx.trace_id, "inbound.enrich", tenant_id,
                t_span, time.monotonic() - t_span, len(batch))
        elif isinstance(batch, RegistrationBatch):
            # same cancellation accounting as the enriched publish: a
            # cancel landing inside this produce must not leave "did the
            # registration request go out?" ambiguous for the commit —
            # settled-and-marked, or provably withdrawn and redelivered
            await produce_settled(runtime.bus, unregistered_topic, batch,
                                  fence=engine.fence_token(), mark=mark)
        else:
            logger.warning("inbound: unknown record %r", type(batch))


class InboundProcessingService(Service):
    identifier = "inbound-processing"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> InboundProcessingEngine:
        return InboundProcessingEngine(self, tenant)
