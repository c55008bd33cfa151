"""Fused ingress fast lane: one consumer loop from decode to scoring admit.

The staged pipeline pays three produce→consume bus hops on the scored
path (decoded → inbound validate → persist/enrich → scoring admit), and
BASELINE.md's round-5 analysis pins the admit-stage tail (p50 5.1 ms,
p99 81.9 ms on the CPU rig) on event-loop scheduling stalls that
COMPOUND across those hops — each produce/poll round-trip is another
chance for a busy loop to stall the woken consumer, and the stalls
multiply into the tail. The per-batch compute was never the problem.

This module is the operator-fusion answer (PAPERS.md: Cloudflow's
fuse-don't-hop rewrite for low-latency serving dataflow; ADApt's
low-latency edge ingest): when a tenant's traffic shape permits, ONE
consumer loop off the decoded topic performs, in a single hop,

  1. weighted-fair admission        (FlowController.admit_fair — FLW01),
  2. registration-mask validation   (the inbound slow lane's vectorized
                                     gather; unregistered devices split
                                     to the unregistered-device topic),
  3. the single inbound produce     (the persister, device-state, and
                                     outbound consumers observe the same
                                     validated batch, exactly one produce,
                                     at-least-once as before), and
  4. scoring admit                  (shed-mode routed: ok→admit,
                                     degrade→host fallback, defer→spool —
                                     identical to the slow lane's policy),

eliminating two produce/poll round-trips from the scored path — and
moving the persist hop OFF that path entirely (persistence still
happens, concurrently, behind the same single inbound produce).

Lane selection (`fastlane_enabled`): auto-detected — in-process bus,
device-management and rule-processing co-resident, a scoring model
configured, and no config-declared rule scripts/geofences (those keep
the fully staged lane so their ordering story is unchanged; hooks added
programmatically at runtime still run at the enriched hop either way).
A tenant `fastlane:` section overrides the detection either way:

    fastlane:
      enabled: true | false

Both inbound-processing (which then does NOT spin its staged consumer)
and rule-processing (which then hosts the `FastLane`) evaluate the same
predicate from config + topology alone, so the services always agree on
the lane. The fused consumer joins the SAME group the staged consumer
would (`{tenant}.inbound-processing`), so a config toggle resumes from
the other lane's committed offsets, and a mixed window during an engine
respin splits partitions instead of duplicating records.

Batches the fast lane has admitted are flagged (`ctx.fastlane`) so the
rule-processing consumer — which still handles hooks, overload
reporting, and deferred replay at the enriched hop — never admits them
a second time. Registration batches, custom-rule tenants,
fastlane-disabled tenants, and wire-bus deployments keep the slow lane
unchanged.

Contracts (machine-checked, docs/ANALYSIS.md): the fused loop consults
the FlowController on its publish path (FLW01), wraps per-record work in
DLQ quarantine (DLQ01), and its fault site (`fastlane.handle`) and
metrics (`fastlane.*`) resolve against `analysis/registry.py`
(FLT01/MET01). See docs/PERFORMANCE.md for the measured before/after.
"""

from __future__ import annotations

import asyncio
import inspect
import logging
import time
from typing import Optional

from sitewhere_tpu_torch.domain.batch import (
    LocationBatch,
    MeasurementBatch,
    RegistrationBatch,
)
from sitewhere_tpu_torch.kernel.bus import FencedError, TopicNaming
from sitewhere_tpu_torch.kernel.egresslane import commit_barrier
from sitewhere_tpu_torch.kernel.lifecycle import (
    BackgroundTaskComponent,
    LifecycleStatus,
)

logger = logging.getLogger(__name__)


def fastlane_enabled(tenant, runtime) -> bool:
    """Should this tenant's decoded topic be consumed by the fused fast
    lane instead of the staged inbound slow lane?

    Pure function of config + runtime topology (no engine state), so
    inbound-processing and rule-processing — whose engines spin
    independently off the tenant-model-updates broadcast — always reach
    the same answer."""
    if not hasattr(runtime.bus, "peek"):
        # wire-bus process: decode and scoring live in different OS
        # processes — there is no single loop to fuse into
        return False
    services = getattr(runtime, "services", None) or {}
    if ("rule-processing" not in services
            or "device-management" not in services):
        return False
    section = tenant.section("fastlane")
    if "enabled" in section:
        return bool(section["enabled"])
    rp = tenant.section("rule-processing", {"model": "zscore"})
    if not rp.get("model", "zscore"):
        return False  # scoring disabled: nothing to fuse toward
    if rp.get("scripts") or rp.get("geofences"):
        # config-declared custom rules keep the fully staged lane
        return False
    return True


def _swallow_result(task: asyncio.Task) -> None:
    if not task.cancelled():
        task.exception()  # retrieve: a late failure is only log-worthy


async def produce_settled(bus, topic, value, *, key=None, fence=None,
                          mark=None) -> None:
    """A produce whose CANCELLATION is unambiguous for commit
    accounting — the third shared lane contract.

    A consumer loop that publishes per-record output and commits
    handled-through offsets has a classic window: a cancellation
    (tenant release, engine stop) landing inside the produce await —
    which on a wire bus is every produce — makes "was it published?"
    unknowable: commit the record and a never-sent publish is LOST;
    don't and a clean handoff re-publishes it through the adopter
    (measured: the wire straddle drill double-scored exactly the batch
    in flight at the release). This helper closes the window: the
    produce runs as a shielded task carrying a SENT probe. The in-proc
    append is synchronous (the probe flips with the append itself);
    the wire client flips it the moment the frame is ON THE SOCKET — a
    written frame on a live connection will be processed by the broker
    regardless of this caller's fate — and a cancellation landing
    while the frame is still queued client-side WITHDRAWS it
    (WireClient.call), so the op observably never happened. On
    cancellation: probe set → the record is on the broker's path,
    `mark()` runs (count it handled — its offset may commit) and the
    shielded task settles in the background; probe unset → the task is
    cancelled and the publish provably never left this process, so
    nothing marks and the adopter redelivers. A FencedError or publish
    failure travels to the caller exactly like a bare produce."""
    sent: list = []
    remote = hasattr(bus, "wire_stats")  # RemoteEventBus: real probe

    # flow admission and the enrich span are the CALLER's obligations
    # (both lanes consult/record before reaching this publish — same
    # rationale as validate_and_split's disables); this helper only
    # changes the publish's cancellation accounting
    async def run():  # swxlint: disable=FLW01,TRC01
        if remote:
            return await bus.produce(topic, value, key=key, fence=fence,
                                     _sent=sent)
        # in-proc: the append IS this first synchronous step
        sent.append(True)
        return await bus.produce(topic, value, key=key, fence=fence)

    task = asyncio.ensure_future(run())
    try:
        await asyncio.shield(task)
    except asyncio.CancelledError:
        if sent:
            if mark is not None:
                mark()
            task.add_done_callback(_swallow_result)
        else:
            # not on the wire yet: cancelling the task makes call()
            # withdraw a still-queued frame — unpublished for certain
            task.cancel()
        raise


async def checkpoint_commit(consumer, sink,
                            ckpt: Optional[tuple[int, dict]],
                            fence=None) -> Optional[tuple[int, dict]]:
    """One at-least-once commit step, shared by the fused fast lane and
    the staged rule processor (one implementation so the lanes cannot
    diverge on the barrier): when the sink is idle, commit directly;
    under steady pipelined load, snapshot positions whenever nothing
    sits unflushed and commit that snapshot once every flush dispatched
    before it has settled AND published (`settled_through` barrier).
    Returns the new checkpoint. A crash redelivers at most the
    unsettled tail.

    `fence` is the engine's TenantFence handle (kernel/service.py): the
    commit threads the live `[tenant, epoch, worker]` token, and a
    broker rejection (FencedError — this worker lost the tenant) is
    reported back instead of retried: the offsets stay untouched for
    the new owner, and the fleet worker stops these engines."""
    tok = fence.token() if fence is not None else None
    try:
        if sink is None or sink.idle:
            consumer.commit(fence=tok)
            return None
        if ckpt is not None and sink.settled_through >= ckpt[0]:
            consumer.commit(ckpt[1], fence=tok)
            ckpt = None
    except FencedError:
        fence.lost()
        return ckpt
    if ckpt is None and sink.pending_n == 0:
        snap = consumer.snapshot_positions()
        if inspect.isawaitable(snap):
            snap = await snap  # consumer on a wire bus
        ckpt = (sink.dispatch_count, snap)
    return ckpt


# both callers (FastLane._handle and InboundProcessor's record wrapper)
# charge `admit_fair` BEFORE invoking this shared core — consulting here
# too would double-bill every batch, same rationale as process_payload.
# TRC01: the span for this path is the caller's "inbound.enrich" (both
# lanes record it around this call on the same record) — a second span
# here would double-count the validate work in the critical path.
async def validate_and_split(batch, dm, runtime, unregistered_topic,  # swxlint: disable=FLW01,TRC01
                             dropped, fence=None):
    """The registration-mask validation BOTH lanes share: gather the
    mask, split unregistered devices to the unregistered-device topic,
    return the selected batch (the input object when nothing split).
    One implementation so the lanes cannot diverge on the validation
    contract the equivalence tests defend. `fence` is the caller
    engine's data-path fencing token (kernel/bus.py)."""
    mask = dm.registered_mask(batch.device_index)
    if inspect.isawaitable(mask):
        mask = await mask  # device-mgmt in a peer process (staged lane)
    n_bad = int((~mask).sum())
    if n_bad:
        dropped.inc(n_bad)
        await runtime.bus.produce(
            unregistered_topic,
            {"device_indices": batch.device_index[~mask],
             "ctx": batch.ctx}, fence=fence)
        batch = batch.select(mask)
    return batch


class FastLane(BackgroundTaskComponent):
    """The fused consumer loop (hosted by a RuleProcessingEngine: it
    owns the scoring sink the fusion targets).

    Sharding (`egress: {lanes: N}`, kernel/egresslane.py): the engine
    hosts N of these, every shard joining the SAME consumer group — the
    bus splits the decoded topic's partitions across them, so flood-mode
    admission scales across loops instead of serializing on one, and a
    lane-count change (config update → engine respin) resumes each
    partition from the group's committed offset. All shards share the
    one `validate_and_split` / `shed_route` / `checkpoint_commit`
    implementation and the one scoring sink, so shard count can never
    change behavior — only concurrency (asserted by
    tests/test_egress.py lane-count equivalence)."""

    def __init__(self, engine, shard: int = 0):
        super().__init__("fastlane" if shard == 0 else f"fastlane-{shard}")
        self.engine = engine
        self.shard = shard
        self._inbound_topic = engine.tenant_topic(TopicNaming.INBOUND_EVENTS)
        self._unregistered_topic = engine.tenant_topic(
            TopicNaming.UNREGISTERED_DEVICES)
        self._deferred_topic = engine.tenant_topic(
            TopicNaming.DEFERRED_EVENTS)
        metrics = engine.runtime.metrics
        self._processed = metrics.meter("fastlane.events_processed")
        self._dropped = metrics.counter("fastlane.events_unregistered")
        self._lost = metrics.counter("fastlane.records_lost")

    async def _run(self) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        # engines start in broadcast order across services — wait, don't race
        dm = await runtime.wait_for_engine("device-management", tenant_id)
        dm_service = runtime.services.get("device-management")
        # sink: dedicated session or the shared pool's tenant slot —
        # slots delegate flush_due/flush_nowait to the POOL, so this
        # lane's turns drive the shared megabatch rounds too
        sink = engine.session or engine.pool_slot
        session = engine.session
        decoded_topic = engine.tenant_topic(TopicNaming.EVENT_SOURCE_DECODED)
        flow = runtime.flow
        # subscribe only after every prior await (a cancellation between
        # subscribe and the try/finally would leak a group member). SAME
        # group name as the slow lane's consumer: toggling the lane
        # (config update → engine respin) resumes from the other lane's
        # committed offsets — no replay, no gap — and if both lanes ever
        # ran at once they would split partitions instead of duplicating
        consumer = runtime.bus.subscribe(
            decoded_topic, group=f"{tenant_id}.inbound-processing")
        lost_seen = 0
        # checkpointed commit, same discipline as the slow lane's rule
        # processor: decoded offsets commit only once every scoring
        # dispatch admitted before the snapshot has settled AND published
        # — a crash redelivers (re-validates, re-produces, re-scores) at
        # most the unsettled tail, which is the staged lanes' combined
        # at-least-once guarantee
        ckpt: Optional[tuple[int, dict]] = None
        # composes the fused egress stage into the barrier when enabled
        # (kernel/egresslane.py): offsets wait for the PUBLISH, exactly
        # like the staged lane's rule processor
        barrier = commit_barrier(sink, engine.egress)
        # handled-through frontier for the clean-handoff commit-through:
        # positions as of the last FULLY handled poll batch — a
        # cancellation mid-batch must not let the stop path commit past
        # records this loop never produced/admitted
        handled = None
        cap = getattr(getattr(session, "cfg", None), "backlog_events", 0)
        if not cap and engine.pool_slot is not None:
            cap = engine.pool_slot.pool.cfg.backlog_events
        # pool slots report max_inflight=0 on purpose (see the staged
        # rule processor): a megabatched tenant's inflight share pegs at
        # the POOL cap under healthy pipelining, and reading that as
        # per-tenant pressure shed floods the scorer was absorbing —
        # the slot's backlog (pending vs cap) is its overload signal
        max_inflight = getattr(getattr(session, "cfg", None),
                               "max_inflight", 0)
        try:
            while True:
                # re-resolve each round: a tenant update swaps the dm engine
                if dm_service is not None:
                    dm = dm_service.engines.get(tenant_id, dm)
                if flow is not None and sink is not None:
                    # this loop is the admitting edge now: feed the
                    # scorer's pressure into the shed policy each round
                    # (the rule processor keeps reporting too — the
                    # update is idempotent)
                    flow.report_scorer(
                        tenant_id, pending=sink.pending_n, cap=cap,
                        inflight=getattr(sink, "inflight", 0),
                        max_inflight=max_inflight)
                if sink is not None and barrier.backlogged:
                    # backpressure through uncommitted bus offsets, same
                    # as the slow lane: stop consuming, keep flushing.
                    # The barrier view covers BOTH capacities — scoring
                    # admission and unpublished egress output.
                    if sink.flush_due:
                        sink.flush_nowait()
                    await asyncio.sleep(
                        max(sink.flush_wait_s, 0.001) if sink.ready else 0.05)
                    continue
                timeout = sink.flush_wait_s if sink is not None else 0.2
                records = await consumer.poll(max_records=256,
                                              timeout=max(timeout, 0.001))
                lost = getattr(consumer, "lost_records", 0)
                if lost > lost_seen:
                    self._lost.inc(lost - lost_seen)
                    lost_seen = lost
                for record in records:
                    # poison quarantine: a record whose fused handling
                    # raises goes to the tenant DLQ with provenance and
                    # the loop keeps draining — admission cost estimation
                    # included (a record whose len() blows up is poison)
                    try:
                        await self._handle(record, dm, sink)
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        await engine.dead_letter(record, exc, self.path)
                if records:
                    handled = consumer.delivered_positions()
                if sink is not None and sink.flush_due:
                    # pipelined: dispatch now; settle/publish runs via the
                    # scored sink without blocking this consumer loop.
                    # Sub-bucket admits gathered above share ONE flush —
                    # the batch window does the coalescing. Pool slots
                    # delegate to the shared megabatch round, so consumer
                    # turns drive the stacked dispatch cadence too.
                    sink.flush_nowait()
                ckpt = await checkpoint_commit(consumer, barrier, ckpt,
                                               fence=engine.fence)
        finally:
            if engine.status == LifecycleStatus.STOPPING:
                # engine stop (release/handoff): the engine's _do_stop
                # commits the handled-through positions once the drain
                # proves them settled AND published — the clean handoff
                # then replays nothing (exactly-once) — and closes it
                engine._stopped_consumers.append((consumer, handled))
            else:
                # supervised restart: leave the group so the fresh
                # consumer's join rebalances cleanly
                consumer.close()

    async def _handle(self, record, dm, sink) -> None:
        """One record through the fused path: fair admission → mask
        validation → single inbound produce → shed-routed scoring admit."""
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        flow = runtime.flow
        batch = record.value
        if flow is not None:
            # weighted-fair admission (kernel/flow.py), exactly where the
            # slow lane charges it: with flow_inbound_rate capped, a hog
            # tenant's backlog drains in proportion to its weight
            try:
                cost = float(len(batch))
            except TypeError:
                cost = 1.0
            await flow.admit_fair(tenant_id, max(cost, 1.0))
        if runtime.faults is not None:
            # acheck, not check: a delay-mode fault must suspend this
            # coroutine, not the event loop
            await runtime.faults.acheck("fastlane.handle")
        # back-dated, not `tracer.span`: the block awaits, and a profiler
        # range open across an await would time other coroutines' work
        t_span = time.monotonic()
        if isinstance(batch, (MeasurementBatch, LocationBatch)):
            batch = await validate_and_split(
                batch, dm, runtime, self._unregistered_topic,
                self._dropped, fence=engine.fence_token())
            if len(batch):
                self._processed.mark(len(batch))
                # flag BEFORE the inbound produce: the rule-processing
                # consumer sees this batch again at the enriched hop
                # (hooks, deferred replay) and must not re-admit it
                batch.ctx.fastlane = True
                # CAN01-disabled: this lane's frontier is BATCH-granular
                # (`delivered_positions()` advances only after the whole
                # poll batch handled), so a cancel inside this produce
                # leaves the frontier before the record — the stop path
                # never commits past it and the adopter redelivers: the
                # at-least-once side is chosen deliberately (the fused
                # lane re-validates idempotently on replay)
                await runtime.bus.produce(self._inbound_topic, batch,  # swxlint: disable=CAN01
                                          key=record.key,
                                          fence=engine.fence_token())
                if sink is not None and isinstance(batch, MeasurementBatch):
                    # the fused scoring admit — the work the slow lane
                    # does two bus hops later, routed by the SAME shed
                    # policy (engine.shed_route: ok → admit, degrade →
                    # host fallback, defer → spool for the rule
                    # processor to drain back)
                    await engine.shed_route(batch, sink, key=record.key)
            # the span name the staged lane records: the fused loop IS
            # the enrich stage, so traces stay comparable across lanes
            runtime.tracer.record(
                batch.ctx.trace_id, "inbound.enrich", tenant_id,
                t_span, time.monotonic() - t_span, len(batch))
        elif isinstance(batch, RegistrationBatch):
            # registration stays on the staged path: hand it to the
            # device-registration consumer exactly like the slow lane.
            # CAN01-disabled: same batch-granular frontier rationale as
            # the inbound produce above — a cancel here redelivers the
            # record, and registration is idempotent on replay
            await runtime.bus.produce(self._unregistered_topic, batch,  # swxlint: disable=CAN01
                                      fence=engine.fence_token())
        else:
            logger.warning("fastlane: unknown record %r", type(batch))
