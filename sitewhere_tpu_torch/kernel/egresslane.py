"""Sharded egress fast lanes: the scored-publish sink tail, fused.

PR 4's ingress fusion (kernel/fastlane.py) made the decoded→admit path
one hop, and the same-day A/B moved the dominant tail to the SINK stage:
p99 61–82 ms of publish-side stalls on both lanes (docs/PERFORMANCE.md).
The cause mirrors the ingress story: every scored flush's settle task
performed its own bus publish AND its anomaly-alert emission inline, so
the publish tail rode the settle task's scheduling luck on a busy event
loop — and a stall in the alert path (an event-store hiccup, a slow
tenant) blocked the scoring flush pipeline itself.

This module is the egress half of the fuse-then-shard playbook
(PAPERS.md: Cloudflow's fuse-don't-hop rewrite; the PMU streaming tier's
separation of scoring from delivery):

- **EgressStage** — one per rule-processing engine. The scoring settle
  path hands it a settled `ScoredBatch` and returns WITHOUT awaiting
  anything: the flush pipeline never blocks on publish or alert work
  again. On the in-proc bus, `submit` publishes synchronously via
  `produce_nowait` when the target shard has no unpublished backlog
  (no await, no wakeup hop — the sink span is the bare append);
  otherwise, and always on wire buses or with a fault injector armed,
  it is a queue append the shard loops drain.
- **EgressShard** — N supervised loops (`egress: {lanes: N}`) drain the
  stage's queues and publish every backlogged batch back-to-back in one
  wakeup (batched publishes amortize task scheduling), then emit anomaly
  alerts off the flush path (`rules.alerts_emitted`). Batches are
  sharded across lanes by the batch's source key — the same key the
  publish partitions by — so per-key publish order is preserved.
- **EgressBarrier** — the at-least-once story. `checkpoint_commit`
  (kernel/fastlane.py, ONE implementation for both consumer lanes) used
  to rely on the settle task awaiting the publish; with the publish
  decoupled, the barrier composes the scoring sink AND the egress
  stage: consumed offsets commit only once every dispatch settled AND
  its scored output left the stage (published, or quarantined with
  provenance — never silently dropped).

Cross-tenant megabatched scoring (scoring/pool.py) fans ONE settled
stacked dispatch back out as N per-tenant `ScoredBatch`es, each entering
its own tenant's EgressStage through the shared `deliver_scored`
contract below — so the dispatch-rate collapse upstream never changes
what egress observes: per-tenant stages, per-tenant DLQs, per-tenant
commit barriers, exactly as if each tenant had flushed alone.

A publish failure dead-letters the scored batch to the tenant DLQ with
egress provenance (`kernel/dlq.py` replay re-publishes it onto the
scored topic); an alert-emission failure after a successful publish is
counted (`egress.alert_failures`) but NOT dead-lettered — a replay
would double-publish the batch. The `egress.publish` chaos site is
consulted per batch inside the quarantine wrapper, and the shard loops
carry the same supervisor/restart budget as every service loop.

Lane config, per tenant (overrides `InstanceSettings.egress_*`):

    egress:
      fused: true | false   # false = legacy inline sink (the A/B lever)
      lanes: N              # egress shards AND ingress consumer lanes

`lanes` is also the shard count for the PR 4 ingress fast lane and the
staged inbound/persist/outbound consumer loops: N loops join the SAME
consumer group, so the bus splits partitions across them and a
lane-count change resumes from the group's committed offsets — no
replay, no gap. Contracts stay shared: every lane routes through the
one `shed_route` / `validate_and_split` / `checkpoint_commit`
implementation, so lanes cannot diverge on policy.

Contracts (machine-checked, docs/ANALYSIS.md): the `egress.publish`
fault site and `egress.*` / `rules.alerts_emitted` metrics resolve
against `analysis/registry.py` (FLT01/MET01); the shard loop's
per-batch handling routes failures to the DLQ with provenance (the
DLQ01 quarantine discipline, applied to an in-memory queue drain).
See docs/PERFORMANCE.md for the measured before/after.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from typing import Optional

from sitewhere_tpu_torch.kernel.bus import (
    EventBus,
    TopicNaming,
    TopicRecord,
    key_hash,
)
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent

logger = logging.getLogger(__name__)


async def deliver_scored(sink, scored, sink_failures, stage_sink,
                         label: str = "") -> None:
    """One settled `ScoredBatch` into a scoring sink, under the ONE
    delivery contract every settle path shares (the dedicated session's
    per-flush settle AND the pool's per-tenant megabatch fan-out):

    - a sink failure is counted (`scoring.sink_failures`) and isolated —
      it can never kill the settle task or, in a megabatch, another
      tenant's delivery;
    - `scoring.stage_sink_s` (settled → published) is observed here only
      for sinks that don't own the stage themselves (`owns_sink_stage`:
      the fused EgressStage observes submit → PUBLISHED on its shard
      loops, and timing the enqueue would record ~0 and hide the tail).

    The pool gathers one of these per tenant of a settled megabatch, so
    a slow legacy-inline sink for one tenant never serializes the other
    tenants' deliveries behind it."""
    t_sink = time.monotonic()
    try:
        await sink(scored)
    except Exception:  # noqa: BLE001 - sink errors can't kill settles
        sink_failures.inc()
        logger.exception("scoring sink failed%s",
                         f" for {label}" if label else "")
    else:
        if not getattr(sink, "owns_sink_stage", False):
            stage_sink.observe(time.monotonic() - t_sink)


def egress_fused(tenant, runtime) -> bool:
    """Is the fused egress stage enabled for this tenant? Pure function
    of config (tenant `egress.fused` over the instance default), so the
    bench lever and tests pin it deterministically."""
    section = tenant.section("egress")
    if "fused" in section:
        return bool(section["fused"])
    return bool(getattr(runtime.settings, "egress_fused", True))


def egress_lanes(tenant, runtime) -> int:
    """Shard count for this tenant's consumer lanes and egress shards
    (tenant `egress.lanes` over the instance default; min 1). Lanes
    beyond the topic's partition count sit unassigned — harmless, but
    pointless; keep lanes ≤ `bus_default_partitions`."""
    section = tenant.section("egress")
    lanes = section.get("lanes",
                        getattr(runtime.settings, "egress_lanes", 1))
    try:
        return max(int(lanes), 1)
    except (TypeError, ValueError):
        return 1


def egress_autotune(tenant, runtime) -> bool:
    """Is the egress lane-count auto-tuner on for this tenant (tenant
    `egress.autotune` over `InstanceSettings.egress_autotune`)? Pure
    function of config, like the other lane predicates."""
    section = tenant.section("egress")
    if "autotune" in section:
        return bool(section["autotune"])
    return bool(getattr(runtime.settings, "egress_autotune", False))


def egress_max_lanes(tenant, runtime) -> int:
    """The auto-tuner's lane ceiling (tenant `egress.max_lanes` over
    the instance default; never below the configured static lanes)."""
    section = tenant.section("egress")
    cap = section.get("max_lanes",
                      getattr(runtime.settings, "egress_autotune_max_lanes",
                              4))
    try:
        return max(int(cap), egress_lanes(tenant, runtime))
    except (TypeError, ValueError):
        return egress_lanes(tenant, runtime)


class EgressStage:
    """Per-tenant fused egress: the scoring sink that never suspends.

    The settle path calls the stage like the old inline sink
    (`await sink(scored)`) — the call enqueues onto a shard keyed by the
    batch's source and returns; the shard loops do the publishing and
    the alert emission. `owns_sink_stage` tells the scoring session/pool
    that THIS stage observes `scoring.stage_sink_s` (submit→published),
    so the histogram keeps meaning "settled → published" across the
    inline and fused configurations."""

    owns_sink_stage = True

    def __init__(self, engine, lanes: int = 1, autotune: bool = False,
                 max_lanes: Optional[int] = None):
        self.engine = engine
        self.scored_topic = engine.tenant_topic(TopicNaming.SCORED_EVENTS)
        self.tracer = engine.runtime.tracer
        metrics = engine.runtime.metrics
        self.published_meter = metrics.meter("egress.events_published")
        self.publish_failures = metrics.counter("egress.publish_failures")
        self.alert_failures = metrics.counter("egress.alert_failures")
        self.alerts_emitted = metrics.counter("rules.alerts_emitted")
        self.stage_sink = metrics.histogram("scoring.stage_sink_s")
        # sync-publish fast path: the in-proc bus appends without ever
        # suspending (`produce_nowait` IS the committed append), so when
        # the target shard has no unpublished backlog (ordering) and no
        # fault injector is armed (the `egress.publish` chaos site lives
        # on the shard path), submit publishes RIGHT HERE — no await, no
        # wakeup hop, no scheduling exposure in the measured sink span.
        # isinstance, NOT hasattr: wire/Kafka buses also expose a
        # produce_nowait, but theirs is fire-and-forget (a spawned RPC
        # whose failure dies detached) — accounting such a publish would
        # commit offsets for a batch that may never land. Non-EventBus
        # backends always take the shard path, whose awaited produce
        # fails into the DLQ with provenance.
        self._produce_nowait = (engine.runtime.bus.produce_nowait
                                if isinstance(engine.runtime.bus, EventBus)
                                else None)
        # at-least-once accounting: a batch is ACCOUNTED once it has
        # been published or quarantined with provenance — the commit
        # barrier (EgressBarrier) holds consumed offsets until
        # submitted == accounted
        self.submitted = 0
        self.accounted = 0
        # lane auto-tune (the self-tuning half of mesh serving): shards
        # are built to the CEILING up front — lifecycle children can't
        # be added under load — and `active` bounds how many submit
        # routes to. Idle shards cost one parked loop each. The tuner
        # (autotune_observe, fed by the TelemetryBeat every beat) moves
        # `active` one lane at a time on sustained signals: backlog per
        # active lane past half the shard cap earns a lane, event-loop
        # lag past the stall threshold while the lanes sit near-empty
        # sheds one (the measured 1-core trade: extra lanes deepen the
        # dispatch queue — docs/PERFORMANCE.md). A switch APPLIES
        # only while the stage is idle, so re-keying can never overtake
        # a shard's backlog and break per-key publish order.
        n = max(lanes, 1)
        ceiling = max(max_lanes or n, n) if autotune else n
        self.shards = [EgressShard(self, i) for i in range(ceiling)]
        self.active = n
        self._autotune = bool(autotune)
        self._pending_active: Optional[int] = None
        self._up_beats = 0
        self._down_beats = 0
        self._last_adjust_t = -1e9
        self.autotune_adjusts = metrics.counter("egress.autotune_adjusts")
        # per-tenant suffix (the registry's `:{suffix}` convention):
        # one stage per tenant writes this gauge, and a shared base
        # name would be last-writer-wins noise with >1 tenant
        self.autotune_gauge = metrics.gauge(
            f"egress.autotune_lanes:{engine.tenant_id}")
        self.autotune_gauge.set(self.active)

    @property
    def lanes(self) -> int:
        return len(self.shards)

    # the tuner's thresholds: N consecutive beats of one signal (a
    # single spike never moves a lane) + a wall-clock cooldown between
    # adjustments; up and down trigger on DISJOINT conditions (high
    # backlog vs lag-with-idle-lanes), so the tuner converges instead
    # of oscillating (test-pinned)
    AUTOTUNE_CONSECUTIVE = 4
    AUTOTUNE_COOLDOWN_S = 5.0

    def autotune_observe(self, loop_lag_s: float, stall_s: float,
                         mode: str = "ok") -> None:
        """One TelemetryBeat observation (kernel/observe.py calls this
        every beat): fold the beat's signals — this stage's backlog,
        the event loop's lag, the tenant's overload mode — into the
        lane tuner."""
        if not self._autotune:
            return
        self._apply_pending()
        per_lane = self.backlog / max(self.active, 1)
        want_up = (per_lane > self.MAX_BACKLOG_PER_SHARD / 2
                   and self.active < len(self.shards))
        # lanes that are not earning their keep: the loop is lagging
        # (or the tenant is shedding) while the shard queues sit
        # near-empty — publish parallelism is not the bottleneck, the
        # extra loops are just dispatch-queue depth
        want_down = (self.active > 1
                     and per_lane < self.MAX_BACKLOG_PER_SHARD / 4
                     and (loop_lag_s >= stall_s or mode != "ok"))
        self._up_beats = self._up_beats + 1 if want_up else 0
        self._down_beats = self._down_beats + 1 if want_down else 0
        now = time.monotonic()
        if now - self._last_adjust_t < self.AUTOTUNE_COOLDOWN_S:
            return
        if self._up_beats >= self.AUTOTUNE_CONSECUTIVE:
            self._pending_active = self.active + 1
        elif self._down_beats >= self.AUTOTUNE_CONSECUTIVE:
            self._pending_active = self.active - 1
        else:
            return
        self._up_beats = self._down_beats = 0
        self._last_adjust_t = now
        self._apply_pending()

    def _apply_pending(self) -> None:
        """Apply a decided lane switch, but ONLY at an idle instant:
        every submitted batch is accounted, so no shard holds backlog a
        re-keyed submission could overtake (per-key publish order is
        the invariant the sync fast path and the partition hash share).
        The stage drains its whole backlog per wakeup, so idle instants
        are frequent even under load; until one arrives the decision
        stays pending and `submit` retries it."""
        if self._pending_active is None or not self.idle:
            return
        self.active = self._pending_active
        self._pending_active = None
        self.autotune_adjusts.inc()
        self.autotune_gauge.set(self.active)
        logger.info("egress[%s]: auto-tuned to %d active lane(s) of %d",
                    self.engine.tenant_id, self.active, len(self.shards))

    # unpublished batches per shard before the consumer loops stop
    # consuming (backlogged below): a slow-but-not-failing publish (a
    # congested wire bus, an alert-store stall wedging a shard loop)
    # must surface as bus backpressure — uncommitted offsets — not as
    # an unbounded in-memory queue
    MAX_BACKLOG_PER_SHARD = 64

    @property
    def backlog(self) -> int:
        return self.submitted - self.accounted

    @property
    def backlogged(self) -> bool:
        """Egress backlog at capacity: the consumer loops consult this
        (through the commit barrier) exactly like the scoring sink's
        `backlogged` — stop consuming, keep draining, offsets hold."""
        # active lanes, not built shards: an auto-tuned stage's idle
        # ceiling shards can't drain anything, so they must not widen
        # the backpressure bound either
        if self.backlog >= self.MAX_BACKLOG_PER_SHARD * max(self.active, 1):
            return True
        # wire bus fire-and-forget window full (kernel/wire.py): a
        # stalled broker must pause the consumer loops through this
        # same barrier instead of growing an unbounded op queue (or,
        # pre-fast-path, an unbounded task set) client-side
        return bool(getattr(self.engine.runtime.bus, "backlogged", False))

    @property
    def idle(self) -> bool:
        return self.submitted == self.accounted

    async def __call__(self, scored) -> None:
        """The sink surface (`Sink = Callable[[ScoredBatch],
        Awaitable[None]]`): enqueue and return — zero awaits, so a
        publish or alert stall can never block a scoring flush."""
        self.submit(scored)

    def submit(self, scored) -> None:
        self._apply_pending()  # a decided lane switch lands idle-only
        key = getattr(scored.ctx, "source", None)
        if key and self.active > 1:
            # THE bus partition hash (kernel/bus.py key_hash): one key,
            # one shard, one partition — per-device publish order holds
            shard = self.shards[key_hash(key) % self.active]
        else:
            shard = self.shards[0]
        self.submitted += 1
        t_submit = time.monotonic()
        if (self._produce_nowait is not None
                and shard.pending_publishes == 0
                and self.engine.runtime.faults is None):
            # sync fast path: publish now (ordering holds — this shard
            # has nothing unpublished ahead), alert emission still rides
            # the shard loop off the flush path. A FencedError here
            # (zombie owner) also falls through: the shard's awaited
            # produce re-raises it into the dead_letter hook, which
            # reports the ownership loss instead of quarantining
            try:
                # the trace spine's egress terminus: the sampled trace
                # of a scored event ends at this publish (sync fast
                # path — the span IS the bare append; a failed append
                # records none, the shard path's span stands for it)
                with self.tracer.span(
                        "egress.publish", self.engine.tenant_id,
                        getattr(scored.ctx, "trace_id", 0), len(scored)):
                    self._produce_nowait(self.scored_topic, scored,
                                         key=key,
                                         fence=self.engine.fence_token())
            except Exception:  # noqa: BLE001 - shard path quarantines
                pass  # fall through: the shard publishes (or DLQs) it
            else:
                self.stage_sink.observe(time.monotonic() - t_submit)
                self.published_meter.mark(len(scored))
                self.accounted += 1
                if (self.engine.emit_alerts
                        and scored.is_anomaly.any()):
                    shard.queue.append((scored, t_submit, False))
                    shard.wake.set()
                return
        shard.pending_publishes += 1
        shard.queue.append((scored, t_submit, True))
        shard.wake.set()

    async def drain(self, timeout: float = 10.0) -> None:
        """Wait for every submitted batch to be accounted (shutdown and
        test quiesce path)."""
        deadline = time.monotonic() + timeout
        while not self.idle and time.monotonic() < deadline:
            await asyncio.sleep(0.005)


class EgressShard(BackgroundTaskComponent):
    """One supervised egress loop: drains its queue slice, publishes
    batched, emits alerts — all off the scoring flush path."""

    def __init__(self, stage: EgressStage, index: int):
        super().__init__("egress" if index == 0 else f"egress-{index}")
        self.stage = stage
        self.queue: deque = deque()
        # queued batches still awaiting PUBLISH (alert-only work items
        # don't count): the submit fast path may only publish inline
        # while this is zero, or it would overtake the backlog and
        # break per-key publish order
        self.pending_publishes = 0
        self.wake = asyncio.Event()

    async def _run(self) -> None:
        stage = self.stage
        engine = stage.engine
        runtime = engine.runtime
        bus = runtime.bus
        while True:
            if not self.queue:
                self.wake.clear()
                if not self.queue:  # submit may land between check+clear
                    await self.wake.wait()
            # drain the whole backlog in one wakeup: the publishes go
            # out back-to-back instead of each paying its own task
            # scheduling round — the batching that kills the sink tail
            while self.queue:
                scored, t_submit, publish = self.queue.popleft()
                if publish:
                    try:
                        if runtime.faults is not None:
                            # acheck, not check: a delay-mode fault must
                            # suspend this coroutine, not the event loop
                            await runtime.faults.acheck("egress.publish")
                        await bus.produce(stage.scored_topic, scored,
                                          key=getattr(scored.ctx,
                                                      "source", None),
                                          fence=engine.fence_token())
                    except asyncio.CancelledError:
                        # shutdown mid-publish: put the batch back so
                        # the stop-path drain (or a restart) finishes
                        # the job
                        self.queue.appendleft((scored, t_submit, True))
                        raise
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        # the scored output is NOT lost: it rides the
                        # DLQ with egress provenance, and a replay
                        # re-produces it onto the scored topic (same key)
                        stage.publish_failures.inc()
                        stage.accounted += 1
                        self.pending_publishes -= 1
                        await engine.dead_letter(
                            _unpublished(stage.scored_topic, scored),
                            exc, self.path)
                        continue
                    now = time.monotonic()
                    stage.stage_sink.observe(now - t_submit)
                    # shard-path publish span: submit → published on the
                    # bus, the same semantics as the sync fast path's
                    stage.tracer.record(
                        getattr(scored.ctx, "trace_id", 0),
                        "egress.publish", engine.tenant_id, t_submit,
                        now - t_submit, len(scored))
                    stage.published_meter.mark(len(scored))
                    stage.accounted += 1
                    self.pending_publishes -= 1
                await self._emit_alerts(scored)

    async def _emit_alerts(self, scored) -> None:
        """Anomaly-alert emission, off the flush path (an alert-store
        stall delays alerts, never scoring). Counted, isolated: a
        failure after the publish must NOT dead-letter the batch — a
        replay would publish it twice."""
        stage = self.stage
        engine = stage.engine
        if not engine.emit_alerts or not scored.is_anomaly.any():
            return
        try:
            em = engine.runtime.api("event-management").management(
                engine.tenant_id)
            alerts = engine.build_anomaly_alerts(scored)
            if len(alerts):
                em.add_alert_batch(alerts)
                stage.alerts_emitted.inc(len(alerts))
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 - counted, not poison
            stage.alert_failures.inc()
            logger.exception("egress[%s]: alert emission failed",
                             engine.tenant_id)

    async def _do_stop(self, monitor) -> None:
        # drain before the task is cancelled: wait (bounded) for the
        # scoring sink to stop producing new submissions, then for this
        # shard's queue to empty. Engine children stop before the
        # engine's own _do_stop (which drains the session), so without
        # this the last settles' scored output would never publish.
        engine = self.stage.engine
        sink = engine.session or engine.pool_slot
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            # pending_publishes, not just the queue: a popped batch
            # mid-`await produce` is in neither — cancelling it now
            # would re-queue it with no live consumer left to drain it
            busy = (bool(self.queue) or self.pending_publishes > 0
                    or (sink is not None
                        and getattr(sink, "inflight", 0) > 0))
            if not busy:
                break
            await asyncio.sleep(0.005)
        await super()._do_stop(monitor)


def _unpublished(topic: str, scored) -> TopicRecord:
    """Provenance record for a scored batch that failed to publish: the
    DLQ entry's original_topic is the scored topic, so a replay
    re-produces the batch exactly where it was headed."""
    return TopicRecord(topic=topic, partition=-1, offset=-1,
                       key=getattr(scored.ctx, "source", None),
                       value=scored, timestamp=time.time())


class EgressBarrier:
    """Composite commit barrier for `checkpoint_commit`: the scoring
    sink (session or pool slot) AND the egress stage. Offsets may
    commit only once everything dispatched before the snapshot has
    settled AND its scored output has left the stage — the same
    "settled AND published" guarantee the inline sink gave, kept intact
    across the decoupling."""

    __slots__ = ("_sink", "_egress")

    def __init__(self, sink, egress: EgressStage):
        self._sink = sink
        self._egress = egress

    @property
    def idle(self) -> bool:
        return self._sink.idle and self._egress.idle

    @property
    def backlogged(self) -> bool:
        # either half at capacity pauses the consumer: scoring admission
        # (the existing backpressure) or unpublished egress output (a
        # slow publish path must not grow an unbounded queue)
        return self._sink.backlogged or self._egress.backlogged

    @property
    def pending_n(self) -> int:
        return self._sink.pending_n

    @property
    def dispatch_count(self) -> int:
        return self._sink.dispatch_count

    @property
    def settled_through(self) -> int:
        # any unaccounted scored output holds the barrier: -1 is below
        # every snapshot's dispatch_count. Conservative — it also waits
        # for submissions newer than the snapshot — but the stage
        # drains its whole backlog per wakeup, so the hold is bounded
        # by one publish round, and correctness never depends on
        # mapping submissions back to dispatch seqs.
        if not self._egress.idle:
            return -1
        return self._sink.settled_through


def commit_barrier(sink, egress: Optional[EgressStage]):
    """The object consumer loops hand to `checkpoint_commit`: the raw
    sink when the egress stage is disabled (legacy inline publish), the
    composite barrier when it is fused — ONE call site shape for both
    configurations, in both consumer lanes."""
    if sink is None or egress is None:
        return sink
    return EgressBarrier(sink, egress)
