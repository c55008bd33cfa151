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
  records (the in-proc bus's `peek`; the wire bus's consumer branch is
  ROADMAP A.1.2), pick the newest snapshot, return it plus the
  mutation records after it. `DeviceManagementEngine._do_initialize`
  applies them and a fresh worker with an EMPTY local data_dir adopts
  a moved tenant from nothing but the bus.

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

import logging
from collections import deque

import asyncio

from sitewhere_tpu_torch.kernel.bus import FencedError, TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import (
    BackgroundTaskComponent,
    LifecycleProgressMonitor,
)
from sitewhere_tpu_torch.utils.roadmap import not_ported

logger = logging.getLogger(__name__)


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

    In-proc buses are peeked (no consumer group). The JAX package reads
    a wire bus with a worker-tagged reader group seeked to the
    beginning; the port has no wire bus yet, and that branch raises."""
    topic = runtime.naming.tenant_topic(tenant_id,
                                        TopicNaming.REGISTRY_STATE)
    peek = getattr(runtime.bus, "peek", None)
    if peek is None:
        raise not_ported(f"registry replay from a wire bus (reader "
                         f"{reader_tag!r})", "A.1.2")
    values = [r.value for r in peek(topic, limit=-1)]
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
