"""Replicated tenant state: the registry rides the bus, not a shared disk.

A worker that adopts a tenant restores its registry from the tenant's
compacted `registry-state` topic, so it needs no shared `data_dir`:

- **RegistryReplicator** — a per-tenant lifecycle child of the
  device-management engine. The SPI's mutation journal
  (`persistence/memory.py _TableSnapshotMixin.journal`) hands it every
  entity write/delete as `(seq, op, table, entity)`; it publishes them
  as `{"kind": "mut", ...}` records on the tenant's compacted
  `registry-state` topic, INTERLEAVING full-snapshot records
  (`{"kind": "snap", "seq", "snapshot"}`) every `snapshot_every`
  mutations — so replay-on-adopt is bounded by the records since the
  last snapshot, and bus retention trims everything older (the
  compaction). Every publish threads the owner's fencing token: a
  zombie owner cannot pollute the replicated state.
- **read_state_topic** — the adopter's side: drain the retained
  records (in-proc `peek`, or a throwaway wire consumer reading from
  the beginning), pick the newest snapshot, return it plus the
  mutation records after it. `DeviceManagementEngine._do_initialize`
  applies them and a fresh worker with an EMPTY local data_dir adopts
  a moved tenant from nothing but the wire bus.

Clean release seals the stream: the replicator's stop path flushes the
mutation buffer and publishes a final snapshot BEFORE the fleet worker
publishes its release record, so the adopter always finds a snapshot at
least as new as the last drain. The worker-local WAL
(persistence/durable.py WriteAheadLog, wired by device_management)
covers the remaining single-node window: a hard-killed broker+worker
host restarts from local snapshot + WAL with a crash bound of the last
appended record instead of the snapshot interval.
"""

from __future__ import annotations

import inspect
import logging
import time
from collections import deque

import asyncio

from sitewhere_tpu_torch.kernel.bus import FencedError, TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import (
    BackgroundTaskComponent,
    LifecycleProgressMonitor,
)

logger = logging.getLogger(__name__)

# a wire replay that has not reached the registry topic's end offsets in
# this long fails the adopting engine's start instead of restoring a
# partial registry
REPLAY_DEADLINE_S = 300.0


class RegistryReplicator(BackgroundTaskComponent):
    """Publish a tenant's registry mutation stream + interleaved
    snapshots to the compacted per-tenant registry-state topic."""

    def __init__(self, engine, snapshot_every: int = 64):
        super().__init__("registry-replicator")
        self.engine = engine
        self.topic = engine.tenant_topic(TopicNaming.REGISTRY_STATE)
        self.snapshot_every = max(int(snapshot_every), 1)
        self._buf: deque = deque()
        self._wake = asyncio.Event()
        self._muts_since_snap = 0
        # entity count of the last published snapshot: the snapshot
        # cadence scales with store size (see _snapshot_due) so a
        # bootstrap of N entities interleaves O(log N) snapshots, not
        # N/snapshot_every full-store copies (O(N^2) serialized bytes)
        self._last_snap_entities = 0
        self._sealed = False

    def _snapshot_due(self) -> bool:
        """Interleave a snapshot once the mutations since the last one
        are worth a full-store copy: at least `snapshot_every`, and at
        least half the store's entity count — replay stays bounded by
        ~3x the data size while snapshot publishing stays O(n log n)
        over any bootstrap."""
        return self._muts_since_snap >= max(self.snapshot_every,
                                            self._last_snap_entities // 2)

    # -- producer side (sync, called from SPI mutations) ---------------------

    def enqueue(self, seq: int, op: str, table: str, entity) -> None:
        """One journaled mutation → buffered for the publish loop."""
        self._buf.append({"kind": "mut", "seq": int(seq), "op": op,
                          "table": table, "entity": entity})
        self._wake.set()

    # -- publish loop --------------------------------------------------------

    async def _run(self) -> None:
        # a fresh owner (first adoption, or a replicator restart) seals
        # its starting point so the topic always holds a snapshot —
        # replay from an adopter is bounded from the first record on
        await self._publish_snapshot()
        while True:
            await self._wake.wait()
            self._wake.clear()
            await self._flush()

    async def _flush(self) -> None:
        engine = self.engine
        bus = engine.runtime.bus
        while self._buf:
            rec = self._buf.popleft()
            try:
                await bus.produce(self.topic, rec,
                                  key=engine.tenant_id,
                                  fence=engine.fence_token())
            except FencedError:
                # zombie owner: the replicated stream belongs to the new
                # owner now — drop the buffer (the new owner's snapshot
                # supersedes it) and report the loss
                self._buf.clear()
                engine.fence_lost()
                return
            self._muts_since_snap += 1
            if self._snapshot_due():
                await self._publish_snapshot()

    async def _publish_snapshot(self) -> None:
        engine = self.engine
        snap = engine.spi.to_snapshot()
        try:
            await engine.runtime.bus.produce(
                self.topic,
                {"kind": "snap", "seq": int(snap.get("seq", 0)),
                 "snapshot": snap},
                key=engine.tenant_id, fence=engine.fence_token())
        except FencedError:
            engine.fence_lost()
            return
        self._muts_since_snap = 0
        self._last_snap_entities = sum(
            len(entities) for entities in snap.get("tables", {}).values())

    async def _do_stop(self, monitor: LifecycleProgressMonitor) -> None:
        await super()._do_stop(monitor)
        # seal on release: flush the tail and publish a final snapshot
        # BEFORE the fleet worker's release record goes out — the
        # adopter's replay then starts from a snapshot that covers
        # everything this owner ever wrote. A fenced stop (zombie)
        # publishes nothing (_flush/_publish_snapshot swallow it).
        if not self._sealed:
            self._sealed = True
            if self.engine.tenant_id not in self.engine.runtime.fence.lost:
                await self._flush()
                await self._publish_snapshot()


async def read_state_topic(runtime, tenant_id: str, *,
                           reader_tag: str = "adopt"
                           ) -> tuple[dict | None, list[dict]]:
    """Drain a tenant's retained registry-state records; returns
    `(latest snapshot record or None, mutation records after it)`.

    In-proc buses are peeked (no consumer group); wire buses use a
    worker-tagged reader group seeked to the beginning and read at least
    through the offsets the topic ended at when the read began — the
    group name deliberately does NOT start with the tenant id, so the
    controller's per-tenant lag aggregation (`{tenant}.{service}`
    groups) never counts replay backlog as scoring lag."""
    topic = runtime.naming.tenant_topic(tenant_id,
                                        TopicNaming.REGISTRY_STATE)
    bus = runtime.bus
    values: list = []
    peek = getattr(bus, "peek", None)
    if peek is not None:
        values = [r.value for r in peek(topic, limit=-1)]
    else:
        # the topic's last offsets as the read starts: an empty poll ends
        # the read only once every one was delivered. A broker whose
        # loop is busy (tenants placed while workers start) may push
        # nothing within one poll's timeout, and stopping there would
        # adopt an empty registry, every event then routed as
        # unregistered and never scored
        last = {}
        end_offsets = getattr(bus, "end_offsets", None)
        if end_offsets is not None:
            ends = end_offsets(topic)
            if inspect.isawaitable(ends):
                ends = await ends
            last = {p: end - 1 for p, end in enumerate(ends) if end > 0}
        deadline = time.monotonic() + REPLAY_DEADLINE_S
        group = f"registry-replay.{tenant_id}.{reader_tag}"
        consumer = bus.subscribe(topic, group=group, name=group)
        try:
            consumer.seek_to_beginning()
            while True:
                records = await consumer.poll(max_records=512, timeout=0.3)
                for r in records:
                    values.append(r.value)
                    if r.offset >= last.get(r.partition, r.offset + 1):
                        del last[r.partition]
                if not records and not last:
                    break
                if not records and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"registry replay of {topic}: partitions "
                        f"{sorted(last)} not read to their end in "
                        f"{REPLAY_DEADLINE_S} s")
        finally:
            consumer.close()
    snap: dict | None = None
    muts: list[dict] = []
    for value in values:
        if not isinstance(value, dict):
            continue
        kind = value.get("kind")
        if kind == "snap":
            # newest snapshot wins; mutations before it are superseded
            if snap is None or int(value.get("seq", 0)) >= \
                    int(snap.get("seq", 0)):
                snap = value
                muts = []
        elif kind == "mut":
            muts.append(value)
    if snap is not None:
        floor = int(snap.get("seq", 0))
        muts = [m for m in muts if int(m.get("seq", 0)) > floor]
    return snap, muts
