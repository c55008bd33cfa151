"""In-process event bus with Kafka-compatible topic semantics.

Rebuilds the capability of SiteWhere's Kafka integration layer
(`MicroserviceKafkaProducer`, `MicroserviceKafkaConsumer`,
`KafkaTopicNaming` — [SURVEY.md §2.1 "Kafka integration", §5.8]) as an
in-process asyncio bus that preserves the semantics the platform relies on:

- named topics split into ordered partitions
- producers partition by key hash (per-device ordering guarantee)
- consumer groups with partition assignment and rebalance on join/leave
- committed offsets per (group, topic, partition) → at-least-once delivery,
  resume-from-last-committed after a consumer restart [SURVEY.md §5.4]
- bounded retention with a moving base offset (old records trimmed)

TPU-first twist: record *values* are expected to be columnar event batches
(see `sitewhere_tpu_torch.domain.batch`), so a "record" is typically thousands of
device events — the per-record asyncio overhead amortizes to ~nothing and
the hot path stays vectorized. Per-event objects never transit the bus.

A real-Kafka adapter can implement the same `produce/subscribe` surface
later without touching any service code (SURVEY.md §7 non-goals at v1).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from sitewhere_tpu_torch.kernel.lifecycle import LifecycleComponent, LifecycleProgressMonitor

logger = logging.getLogger(__name__)


def key_hash(key: str) -> int:
    """THE record-key hash: partition selection here and shard routing
    in kernel/egresslane.py must agree, or the egress stage's per-key
    publish-order guard stops corresponding to the partition it
    protects — change it in one place or not at all."""
    return zlib.crc32(key.encode())


class FencedError(RuntimeError):
    """A data-path write carried a stale fencing token: the tenant's
    placement moved and this writer is no longer the owner.

    The worker-side contract (docs/FLEET.md fencing protocol) is "stop
    engines, do not retry": the write was REJECTED broker-side — a
    zombie owner (false-positive death, SIGSTOP past `dead_after`)
    cannot commit offsets or publish records for a tenant another
    worker now owns. `tenant`/`epoch` carry the rejected token's
    identity when known, so an asynchronously-surfacing rejection (a
    fire-and-forget wire commit) can be matched against the CURRENT
    grant — a stale rejection must not fence a legitimately
    re-adopted tenant."""

    def __init__(self, message: str, tenant: Optional[str] = None,
                 epoch: Optional[int] = None):
        super().__init__(message)
        self.tenant = tenant
        self.epoch = epoch


# fencing watches the fleet-control topic for placement/release records
# (TopicNaming.FLEET_CONTROL under the instance scope)
_FLEET_CONTROL_SUFFIX = ".instance.fleet-control"


class FenceAuthority:
    """Broker-side fencing truth: which worker may write each tenant's
    data path (one per `EventBus`, built lazily from the fleet-control
    records that already flow through the broker).

    The token a fleet worker threads on every data-path produce/commit
    is `[tenant, epoch, worker]` — epoch is the placement epoch at which
    the worker adopted. Ownership transfers mirror the worker-side
    drain-then-handoff protocol exactly:

    - a placement that KEEPS a tenant's owner re-affirms it;
    - a placement that MOVES a tenant whose old owner is still in the
      record's live-worker list leaves the old owner fenced-IN until its
      release record lands (the drain's final commits must pass);
    - a placement that moves a tenant whose old owner is absent from the
      live list (declared dead, left) fences the old owner IMMEDIATELY —
      this is the zombie window the grace timers used to merely shrink,
      closed by construction: the SIGCONT'd worker's first write is
      rejected, not tolerated.

    Writes with NO token pass (ingress edges, non-fleet runtimes, the
    control plane itself); the FEN01 lint contract is what guarantees
    fleet-managed tenant modules always present one."""

    __slots__ = ("owners", "pending", "rejections")

    def __init__(self) -> None:
        self.owners: dict[str, tuple[str, int]] = {}   # tenant -> (worker, epoch)
        self.pending: dict[str, tuple[str, int]] = {}  # awaiting old owner's release
        self.rejections = 0

    def observe(self, value) -> None:
        """Fold one fleet-control record into the ownership table.

        The grant rule must mirror the worker-side `_adoptable` EXACTLY
        (fleet/worker.py), keyed off the placement record's `prev` map —
        the controller's best-known ACTUAL owners, not the assignment:
        an assignment that moved again before its first assignee ever
        adopted must not leave the authority waiting on a release from
        a worker that never owned the tenant (measured: that divergence
        fenced a legitimate replacement adopter in an adopt→fence→
        release loop and wedged the tenant)."""
        kind = value.get("kind") if isinstance(value, dict) else None
        if kind == "placement":
            epoch = int(value.get("epoch", -1))
            assignment = value.get("assignment") or {}
            prev = value.get("prev") or {}
            live = set(value.get("workers") or ())
            for tenant, worker in assignment.items():
                actual = prev.get(tenant)
                if actual is None or actual == worker \
                        or actual not in live:
                    # exactly the adopter's immediate-adopt cases: the
                    # tenant is owner-free, kept, or its owner is dead/
                    # left (a corpse can't ack — and a ZOMBIE corpse's
                    # next write must be rejected, which this transfer
                    # is what guarantees)
                    self.owners[tenant] = (worker, epoch)
                    self.pending.pop(tenant, None)
                else:
                    # live actual owner: it is draining — its final
                    # commits must pass until its release record lands
                    self.owners[tenant] = (actual,
                                           self.owners.get(tenant,
                                                           (actual,
                                                            epoch))[1])
                    self.pending[tenant] = (worker, epoch)
            for tenant in [t for t in self.owners if t not in assignment]:
                # tenant left the placement (deleted): nothing to fence
                self.owners.pop(tenant, None)
                self.pending.pop(tenant, None)
        elif kind == "release":
            tenant = value.get("tenant")
            worker = value.get("worker")
            cur = self.owners.get(tenant)
            nxt = self.pending.get(tenant)
            if cur is not None and cur[0] == worker and nxt is not None:
                # the draining owner finished: promote the adopter
                self.owners[tenant] = nxt
                self.pending.pop(tenant, None)

    def check(self, token) -> None:
        """Validate a data-path fencing token; raises FencedError."""
        try:
            tenant, epoch, worker = token
        except (TypeError, ValueError):
            raise FencedError(f"malformed fence token {token!r}") from None
        cur = self.owners.get(tenant)
        if cur is None or worker == cur[0]:
            # unknown tenant (fencing not established) or the allowed
            # writer — same-worker tokens pass across epochs: ownership
            # never changed hands, so there is no zombie to reject
            return
        self.rejections += 1
        raise FencedError(
            f"fenced: tenant {tenant!r} write from {worker!r} (adopted at "
            f"epoch {epoch}) rejected — epoch {cur[1]} placed it on "
            f"{cur[0]!r}; this writer is no longer the owner (stop "
            f"engines, do not retry)", tenant=tenant, epoch=epoch)


@dataclass(frozen=True, slots=True)
class TopicRecord:
    """One record as seen by a consumer (analog of ConsumerRecord)."""

    topic: str
    partition: int
    offset: int
    key: Optional[str]
    value: Any
    timestamp: float


def _event_weight(value: Any) -> int:
    """Events carried by one record: columnar batches (MeasurementBatch,
    ScoredBatch — anything with a meaningful `len`) count their rows;
    control/containter types and scalars count 1. Kept cheap — it runs
    once per produce on the hot path."""
    if isinstance(value, (str, bytes, dict, list, tuple)) or value is None:
        return 1
    try:
        return max(int(len(value)), 1)
    except TypeError:
        return 1


class _PartitionLog:
    """Append-only log for one partition, with bounded retention.

    Waiters are per-consumer `asyncio.Event`s registered by `poll` on
    EVERY assigned partition, so a consumer owning several partitions
    wakes on the first record to arrive on any of them (the old
    one-condition-per-poll design degraded to a 50 ms re-check loop for
    multi-partition assignments — wake-up jitter that landed directly in
    the paced-p99 measurement).

    Beside the record list the log keeps a running cumulative EVENT
    count per record (`_ecum`, absolute from partition origin;
    `_ebase` = events before records[0]), so event-weighted lag —
    "how many EVENTS is this group behind", not "how many records" —
    is O(1) per partition. Offset-counted lag under-reports a backlog
    of columnar batches by the batch size (a 400k-event backlog of
    1024-row batches reads as ~400), which starves anything scaling on
    the signal."""

    __slots__ = ("records", "base_offset", "waiters", "_ecum", "_ebase")

    def __init__(self) -> None:
        self.records: list[tuple[Optional[str], Any, float]] = []
        self.base_offset = 0  # offset of records[0]
        self.waiters: set[asyncio.Event] = set()
        self._ecum: list[int] = []  # cumulative events through records[i]
        self._ebase = 0             # events before records[0]

    @property
    def end_offset(self) -> int:
        return self.base_offset + len(self.records)

    def append(self, key: Optional[str], value: Any) -> None:
        self.records.append((key, value, time.time()))
        prev = self._ecum[-1] if self._ecum else self._ebase
        self._ecum.append(prev + _event_weight(value))

    def events_ahead(self, committed: int) -> int:
        """Events in records at offsets >= `committed` (event-weighted
        lag for one partition)."""
        if not self.records:
            return 0
        i = committed - self.base_offset
        if i >= len(self.records):
            return 0
        floor = self._ebase if i <= 0 else self._ecum[i - 1]
        return self._ecum[-1] - floor

    def notify(self) -> None:
        for w in self.waiters:
            w.set()

    def trim(self, retain: int) -> None:
        excess = len(self.records) - retain
        if excess > 0:
            del self.records[:excess]
            self.base_offset += excess
            self._ebase = self._ecum[excess - 1]
            del self._ecum[:excess]


class _Topic:
    __slots__ = ("name", "partitions", "retention")

    def __init__(self, name: str, num_partitions: int, retention: int) -> None:
        self.name = name
        self.partitions = [_PartitionLog() for _ in range(num_partitions)]
        self.retention = retention


@dataclass
class _GroupState:
    """Consumer-group bookkeeping: members, assignment, committed offsets."""

    members: list["BusConsumer"] = field(default_factory=list)
    # (topic, partition) -> committed offset (next offset to read)
    committed: dict[tuple[str, int], int] = field(default_factory=dict)
    generation: int = 0

    def rebalance(self, bus: "EventBus") -> None:
        """Range-assign every subscribed topic's partitions over members."""
        self.generation += 1
        for member in self.members:
            member._assignment = []
        for topic_name in sorted({t for m in self.members for t in m._topics}):
            topic = bus._topics.get(topic_name)
            if topic is None:
                continue
            subscribers = [m for m in self.members if topic_name in m._topics]
            for p in range(len(topic.partitions)):
                owner = subscribers[p % len(subscribers)]
                owner._assignment.append((topic_name, p))
        for member in self.members:
            member._positions = {}  # re-fetch from committed on next poll
            member._generation = self.generation
            if member._wake is not None:
                member._wake.set()  # re-register waiters on the new assignment


class EventBus(LifecycleComponent):
    """The instance-wide topic bus (one per ServiceRuntime)."""

    def __init__(self, name: str = "event-bus", *, default_partitions: int = 4,
                 retention: int = 4096):
        super().__init__(name)
        self._topics: dict[str, _Topic] = {}
        self._groups: dict[str, _GroupState] = {}
        self._default_partitions = default_partitions
        self._retention = retention
        self._rr = itertools.count()  # round-robin for keyless produce
        # chaos seam (kernel/faults.py): None in production — produce/
        # poll consult the armed sites only when an injector is installed
        self.faults = None
        # epoch fencing (docs/FLEET.md): built lazily from the first
        # fleet-control placement record to flow through this broker;
        # None on non-fleet buses — the hot path pays one suffix test
        self.fences: Optional[FenceAuthority] = None
        # broker-side member eviction (docs/FLEET.md): the live-worker
        # set of the last placement record. A worker DROPPED from it
        # (declared dead, or left) has its owner-tagged consumer-group
        # members evicted, so a SIGSTOPped zombie's memberships stop
        # stalling their partitions until SIGCONT — the session-timeout
        # analog the in-proc bus never had. None until the first
        # placement flows through.
        self._fleet_live: Optional[set[str]] = None
        # optional metrics registry (set by the runtime that OWNS this
        # bus) so fenced rejections surface as `fence.rejections`
        self.metrics = None
        # broker self-stats (stats()): evictions counted on the bus
        # itself beside the metrics counter, so the wire `bus_stats` op
        # reports them even when no runtime wired a registry
        self.members_evicted = 0

    # -- admin -------------------------------------------------------------

    def create_topic(self, name: str, *, partitions: Optional[int] = None,
                     retention: Optional[int] = None) -> None:
        if name not in self._topics:
            self._topics[name] = _Topic(
                name, partitions or self._default_partitions,
                retention or self._retention)

    def topic_names(self) -> list[str]:
        return sorted(self._topics)

    def end_offsets(self, topic: str) -> list[int]:
        self.create_topic(topic)
        return [p.end_offset for p in self._topics[topic].partitions]

    def group_lags(self, *, events: bool = False
                   ) -> dict[str, dict[str, int]]:
        """Consumer lag per group: head minus committed, summed per
        topic — the telemetry beat's backlog signal (kernel/observe.py)
        and the input ROADMAP item 2's placement controller scales
        replicas on. A partition a group never committed counts its
        full retained backlog (earliest-reset semantics: every retained
        record is still ahead of the group).

        `events=True` weights each record by the events it carries
        (columnar batch rows) instead of counting offsets — the signal
        anything SCALING on lag should read: a backlog of 1024-row
        batches under-reports by 3 orders of magnitude in record units,
        so a queue can grow without bound while offset-lag idles below
        any threshold. O(1) per partition either way."""
        out: dict[str, dict[str, int]] = {}
        for group, state in self._groups.items():
            lags: dict[str, int] = {}
            # union member subscriptions with committed-offset topics: a
            # group whose consumers all died (crash window, reconfigure)
            # must keep reporting its growing backlog — that outage is
            # exactly when this signal matters
            topics = {t for m in state.members for t in m._topics} \
                | {t for t, _ in state.committed}
            for topic_name in topics:
                topic = self._topics.get(topic_name)
                if topic is None:
                    continue
                total = 0
                for p, log in enumerate(topic.partitions):
                    committed = state.committed.get((topic_name, p),
                                                    log.base_offset)
                    if events:
                        total += log.events_ahead(committed)
                    else:
                        total += max(log.end_offset - committed, 0)
                if total:
                    lags[topic_name] = total
            out[group] = lags
        return out

    def stats(self) -> dict:
        """The broker's OWN health surface (wire op `bus_stats`,
        `GET /api/fleet` broker block): per-topic retained depth +
        head offsets, per-group total lag + live member count, fence
        rejections, members evicted. The broker used to be the one
        fleet component with no stats of its own — every other signal
        was inferred from the consumers around it."""
        topics: dict[str, dict] = {}
        for name, topic in sorted(self._topics.items()):
            depth = sum(len(p.records) for p in topic.partitions)
            topics[name] = {
                "partitions": len(topic.partitions),
                "depth": depth,
                "end_offset": sum(p.end_offset for p in topic.partitions),
                "retention": topic.retention,
            }
        lags = self.group_lags()
        groups: dict[str, dict] = {}
        for group, state in sorted(self._groups.items()):
            groups[group] = {
                "members": len(state.members),
                "lag": sum((lags.get(group) or {}).values()),
                "generation": state.generation,
            }
        return {
            "topics": topics,
            "groups": groups,
            "fence_rejections": (self.fences.rejections
                                 if self.fences is not None else 0),
            "members_evicted": self.members_evicted,
            "fleet_live": sorted(self._fleet_live or ()),
        }

    def peek(self, topic: str, *, limit: int = 100) -> list[TopicRecord]:
        """Admin read: the newest `limit` retained records of `topic`
        across partitions, oldest-first, without joining any consumer
        group (the DLQ listing surface — no offsets move)."""
        t = self._topics.get(topic)
        if t is None:
            return []
        out: list[TopicRecord] = []
        for p, log in enumerate(t.partitions):
            for i, (key, value, ts) in enumerate(log.records):
                out.append(TopicRecord(topic, p, log.base_offset + i,
                                       key, value, ts))
        out.sort(key=lambda r: r.timestamp)
        if limit < 0:
            return out
        return out[-limit:] if limit else []  # out[-0:] would be ALL

    # -- fencing -----------------------------------------------------------

    def check_fence(self, fence) -> None:
        """Validate a data-path fencing token against the live placement
        (no-op without a token or before any placement was seen)."""
        if fence is not None and self.fences is not None:
            try:
                self.fences.check(fence)
            except FencedError:
                if self.metrics is not None:
                    self.metrics.counter("fence.rejections").inc()
                raise

    def _observe_control(self, value) -> None:
        kind = value.get("kind") if isinstance(value, dict) else None
        if kind in ("placement", "release"):
            if self.fences is None:
                self.fences = FenceAuthority()
            self.fences.observe(value)
        if kind == "placement":
            live = set(value.get("workers") or ())
            if self._fleet_live is not None:
                # the controller's death declaration IS the drop from
                # the live list (a graceful leave closed its own
                # consumers already — eviction is then a no-op)
                for wid in sorted(self._fleet_live - live):
                    self.evict_owner(wid)
            self._fleet_live = live

    def evict_owner(self, owner: str) -> int:
        """Evict every consumer-group member a worker registered
        (`subscribe(owner=...)`): the member leaves its group — its
        partitions reassign to surviving members NOW — and any late
        commit from it is refused. The fence authority already rejects
        a zombie's tenant-scoped writes; this closes the remaining
        stall: a silent member holds its partition assignment forever
        on a bus with no session timeout, so the NEW owner of a moved
        tenant would share (and wait on) partitions a SIGSTOPped
        process can never drain."""
        evicted = 0
        for state in self._groups.values():
            for member in [m for m in state.members if m.owner == owner]:
                if all(t.endswith(_FLEET_CONTROL_SUFFIX)
                       for t in member._topics):
                    # NEVER evict a worker's fleet-control subscription:
                    # each worker consumes the control topic under its
                    # own group (broadcast semantics — no partition
                    # contention to relieve), and a falsely-declared
                    # worker that resumes must still SEE placement
                    # records, or it would heartbeat as live while
                    # permanently deaf to every epoch after its death
                    # declaration
                    continue
                member.evicted = True
                member.close()
                evicted += 1
        if evicted:
            self.members_evicted += evicted
            logger.warning(
                "bus: evicted %d consumer-group member(s) of dead worker "
                "%s; their partitions reassign now", evicted, owner)
            if self.metrics is not None:
                self.metrics.counter("fleet.members_evicted").inc(evicted)
        return evicted

    # -- produce -----------------------------------------------------------

    def _select_partition(self, topic: _Topic, key: Optional[str]) -> int:
        n = len(topic.partitions)
        if key is None:
            return next(self._rr) % n
        return key_hash(key) % n

    async def produce(self, topic_name: str, value: Any, *,
                      key: Optional[str] = None,
                      partition: Optional[int] = None,
                      fence=None) -> tuple[int, int]:
        """Append a record; returns (partition, offset). `fence` is the
        data-path fencing token a fleet tenant owner threads
        (`[tenant, epoch, worker]`) — a stale token raises FencedError
        BEFORE anything is appended."""
        if self.faults is not None:
            await self.faults.acheck("bus.produce")
        self.check_fence(fence)
        if topic_name.endswith(_FLEET_CONTROL_SUFFIX):
            self._observe_control(value)
        self.create_topic(topic_name)
        topic = self._topics[topic_name]
        p = partition if partition is not None else self._select_partition(topic, key)
        log = topic.partitions[p]
        offset = log.end_offset
        log.append(key, value)
        log.trim(topic.retention)
        log.notify()
        return p, offset

    def produce_nowait(self, topic_name: str, value: Any, *,
                       key: Optional[str] = None,
                       partition: Optional[int] = None,
                       fence=None) -> tuple[int, int]:
        """Synchronous append for non-async producers (e.g. bench loops).

        Waiting consumers are woken via call_soon on the running loop if any.
        """
        self.check_fence(fence)
        if topic_name.endswith(_FLEET_CONTROL_SUFFIX):
            self._observe_control(value)
        self.create_topic(topic_name)
        topic = self._topics[topic_name]
        p = partition if partition is not None else self._select_partition(topic, key)
        log = topic.partitions[p]
        offset = log.end_offset
        log.append(key, value)
        log.trim(topic.retention)
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass  # no loop running in this thread: no waiter can exist on it
        else:
            log.notify()
        return p, offset

    # -- consume -----------------------------------------------------------

    def subscribe(self, topics: Iterable[str] | str, *, group: str,
                  name: Optional[str] = None,
                  owner: Optional[str] = None) -> "BusConsumer":
        """`owner` tags the member with the fleet worker that holds it
        (threaded through the wire subscribe by worker processes), so a
        controller death declaration can evict the dead worker's
        memberships broker-side (`evict_owner`)."""
        if isinstance(topics, str):
            topics = [topics]
        for t in topics:
            self.create_topic(t)
        state = self._groups.setdefault(group, _GroupState())
        consumer = BusConsumer(self, group, list(topics),
                               name or f"{group}-{len(state.members)}",
                               owner=owner)
        state.members.append(consumer)
        state.rebalance(self)
        return consumer

    def _leave(self, consumer: "BusConsumer") -> None:
        state = self._groups.get(consumer.group)
        if state and consumer in state.members:
            state.members.remove(consumer)
            if state.members:
                state.rebalance(self)

    async def _do_stop(self, monitor: LifecycleProgressMonitor) -> None:
        # wake all pollers so closing consumers notice shutdown promptly
        for topic in self._topics.values():
            for log in topic.partitions:
                log.notify()


class BusConsumer:
    """A consumer-group member (analog of MicroserviceKafkaConsumer).

    `poll()` returns records past this member's position on its assigned
    partitions; `commit()` persists positions to the group so a restarted
    member resumes from last commit (at-least-once).
    """

    def __init__(self, bus: EventBus, group: str, topics: list[str],
                 name: str, owner: Optional[str] = None):
        self._bus = bus
        self.group = group
        self.name = name
        self.owner = owner      # fleet worker holding this membership
        self.evicted = False    # closed broker-side on a death declaration
        self._topics = topics
        self._assignment: list[tuple[str, int]] = []
        self._positions: dict[tuple[str, int], int] = {}
        self._generation = -1
        self._closed = False
        self._wake: Optional[asyncio.Event] = None  # set while poll wait
        # records trimmed past this member's read position before it got
        # to them (retention overrun: the consumer paused — backpressure,
        # warmup — longer than the retention window covers). At-least-once
        # holds only WITHIN the retention window; this counter makes an
        # overrun loud instead of a silent fast-forward.
        self.lost_records = 0

    @property
    def assignment(self) -> tuple[tuple[str, int], ...]:
        return tuple(self._assignment)

    def _position(self, tp: tuple[str, int]) -> int:
        pos = self._positions.get(tp)
        if pos is None:
            state = self._bus._groups[self.group]
            committed = state.committed.get(tp)
            log = self._bus._topics[tp[0]].partitions[tp[1]]
            pos = committed if committed is not None else 0
            if pos < log.base_offset:
                if committed is not None:
                    # trimmed past a COMMITTED offset: genuine loss. (A
                    # group with no commit is just earliest-reset — it
                    # never claimed those records.)
                    self.lost_records += log.base_offset - pos
                    logger.warning(
                        "%s: offset %d behind base %d on %s — %d records "
                        "trimmed unread (retention overrun)", self.name,
                        pos, log.base_offset, tp, log.base_offset - pos)
                pos = log.base_offset
            self._positions[tp] = pos
        return pos

    def poll_nowait(self, max_records: int = 512) -> list[TopicRecord]:
        """Drain available records without waiting."""
        if self._closed:
            # an evicted/closed member keeps its stale assignment list
            # (rebalance only rewrites live members); reading through it
            # would let a zombie re-consume partitions the group already
            # reassigned
            return []
        if self._bus.faults is not None:
            # chaos site: a fault here crashes the consuming service
            # loop BEFORE any position advances — the supervisor
            # restarts it and uncommitted records redeliver
            self._bus.faults.check("bus.poll")
        out: list[TopicRecord] = []
        for tp in self._assignment:
            if len(out) >= max_records:
                break
            topic_name, p = tp
            log = self._bus._topics[topic_name].partitions[p]
            pos = self._position(tp)
            if pos < log.base_offset:
                # a pause longer than retention covers (e.g. a consumer
                # holding off while its sink is backlogged) trims records
                # this member never read — account the loss loudly, and
                # persist the fast-forward so the same trim is counted
                # ONCE, not once per poll
                self.lost_records += log.base_offset - pos
                logger.warning(
                    "%s: %d records on %s trimmed unread (retention "
                    "overrun while paused)", self.name,
                    log.base_offset - pos, tp)
                pos = log.base_offset
                self._positions[tp] = pos
            take = min(log.end_offset - pos, max_records - len(out))
            if take <= 0:
                continue
            start = pos - log.base_offset
            for i in range(take):
                key, value, ts = log.records[start + i]
                out.append(TopicRecord(topic_name, p, pos + i, key, value, ts))
            self._positions[tp] = pos + take
        return out

    async def poll(self, *, max_records: int = 512,
                   timeout: float = 1.0) -> list[TopicRecord]:
        """Wait up to `timeout` for records on assigned partitions.

        Always yields to the event loop at least once: asyncio's fast
        paths (uncontended locks, non-empty queues) never suspend, so
        without this a saturated consumer loop monopolizes the loop and
        starves every other service for seconds (observed: wedged
        scoring under flood).
        """
        await asyncio.sleep(0)
        records = self.poll_nowait(max_records)
        if records or self._closed:
            return records
        # register one wake event on EVERY assigned partition: the first
        # record to land on any of them (or a rebalance/close) wakes us
        deadline = time.monotonic() + timeout
        while not records and not self._closed:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            if not self._assignment:
                # unassigned (more members than partitions): a rebalance is
                # the only thing that could change that — cheap re-check
                await asyncio.sleep(min(remaining, 0.05))
            else:
                ev = asyncio.Event()
                self._wake = ev
                logs = [self._bus._topics[t].partitions[p]
                        for t, p in self._assignment]
                for log in logs:
                    log.waiters.add(ev)
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    pass
                finally:
                    self._wake = None
                    for log in logs:
                        log.waiters.discard(ev)
            records = self.poll_nowait(max_records)
        return records

    def commit(self, positions: Optional[dict[tuple[str, int], int]] = None,
               *, fence=None) -> None:
        """Commit positions to the group (next-offset convention).

        With `positions` (a snapshot from `snapshot_positions()`), commits
        exactly those offsets — the checkpointed-commit pattern: snapshot
        when the processing pipeline is empty, commit once everything
        dispatched before the snapshot has been published. `fence` is the
        data-path fencing token (see `EventBus.produce`): a stale-epoch
        commit raises FencedError and advances NOTHING — a zombie owner
        can never move a tenant group's offsets."""
        # fence FIRST: a stale-epoch commit on a fenced tenant group
        # must keep raising the TYPED FencedError (it travels the wire
        # and fires on_fenced — the worker's ownership-loss signal);
        # the eviction refusal below covers the unfenced remainder
        self._bus.check_fence(fence)
        if self.evicted:
            # a death-declared worker's membership: its offsets are the
            # group's (and possibly a new owner's) truth now — a late
            # commit from the zombie must not move them, even where no
            # fence token rides the call
            raise RuntimeError(
                f"consumer {self.name} was evicted from group "
                f"{self.group} (owner declared dead); commit refused")
        state = self._bus._groups[self.group]
        src = positions if positions is not None else self._positions
        for tp, pos in src.items():
            prev = state.committed.get(tp, 0)
            if pos > prev:
                state.committed[tp] = pos

    def snapshot_positions(self) -> dict[tuple[str, int], int]:
        """Current read positions (for a deferred checkpointed commit)."""
        return dict(self._positions)

    def delivered_positions(self) -> dict[tuple[str, int], int]:
        """Synchronous copy of delivered-through positions — same as
        `snapshot_positions` in-proc; exists so callers that must stay
        sync (a cancelled loop's finally, the clean-handoff
        commit-through) have one name that works on the remote
        consumer too (whose `snapshot_positions` is a coroutine)."""
        return dict(self._positions)

    def seek_to_beginning(self) -> None:
        for tp in self._assignment:
            log = self._bus._topics[tp[0]].partitions[tp[1]]
            self._positions[tp] = log.base_offset

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._bus._leave(self)
            if self._wake is not None:
                self._wake.set()  # a poll blocked in wait returns promptly


class TopicNaming:
    """Topic naming convention (reference: `KafkaTopicNaming`).

    `<instance>.tenant.<tenant>.<function>` for tenant-scoped topics and
    `<instance>.instance.<function>` for instance-global ones — kept verbatim
    so dashboards/adapters written against the reference's names still work.
    """

    # tenant-scoped pipeline functions [SURVEY.md §3.2]
    EVENT_SOURCE_DECODED = "event-source-decoded-events"
    EVENT_SOURCE_FAILED = "event-source-failed-decode-events"
    INBOUND_EVENTS = "inbound-events"
    INBOUND_REPROCESS = "inbound-reprocess-events"
    UNREGISTERED_DEVICES = "unregistered-device-events"
    INBOUND_PERSISTED = "inbound-persisted-events"
    OUTBOUND_ENRICHED = "outbound-enriched-events"
    OUTBOUND_COMMANDS = "outbound-command-invocations"
    UNDELIVERED_COMMANDS = "undelivered-command-invocations"
    BATCH_ELEMENTS = "batch-operation-elements"
    SCORED_EVENTS = "scored-events"              # new: model-plane output
    DEAD_LETTER = "dead-letter-events"           # poison-record quarantine
    DEFERRED_EVENTS = "deferred-events"          # overload spool (flow.py)
    REGISTRY_STATE = "registry-state"            # replicated tenant state
    #   (services/replication.py: device-registry mutations + interleaved
    #    snapshot records — what a hermetic adopter replays instead of a
    #    shared-filesystem registry.snap)
    # instance-scoped
    TENANT_MODEL_UPDATES = "tenant-model-updates"
    INSTANCE_LOGS = "instance-logs"
    FLEET_CONTROL = "fleet-control"              # placement/heartbeats (fleet/)
    INSTANCE_TELEMETRY = "telemetry"             # per-worker beat snapshots
    #   (kernel/observe.py export → fleet/observer.py merge: each
    #    worker's TelemetryBeat publishes its sample + span summaries
    #    here; bounded like any topic — the observer folds the stream,
    #    it never needs deep history)

    def __init__(self, instance_id: str):
        self.instance_id = instance_id

    def tenant_topic(self, tenant_id: str, function: str) -> str:
        return f"{self.instance_id}.tenant.{tenant_id}.{function}"

    def instance_topic(self, function: str) -> str:
        return f"{self.instance_id}.instance.{function}"

    def split_tenant_topic(self, topic: str):
        """→ (tenant_id, function) for a tenant-scoped topic of THIS
        instance, else None (foreign/instance-scoped topics). The Kafka
        endpoint uses this to attribute a Produce to a tenant quota."""
        prefix = f"{self.instance_id}.tenant."
        if not topic.startswith(prefix):
            return None
        tenant_id, _, function = topic[len(prefix):].partition(".")
        if not tenant_id or not function:
            return None
        return tenant_id, function
