"""device-management service (reference: service-device-management,
[SURVEY.md §2.2]): CRUD + query for device types/commands/statuses,
devices, assignments, groups, customers, areas, zones.

The reference exposes this over gRPC and every inbound event pays a
per-event lookup RPC [SURVEY.md §3.2 hot-loop note]. Here the SPI is
served in-proc, and the hot path never calls it per event: ingest
validates whole batches against the engine's dense `registered` mask
(one vectorized gather per batch).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Optional

import numpy as np

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.model import (
    Device,
    DeviceAssignment,
    DeviceType,
)
from sitewhere_tpu_torch.kernel import codec
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine
from sitewhere_tpu_torch.persistence.durable import WriteAheadLog, load_snapshot
from sitewhere_tpu_torch.persistence.memory import InMemoryDeviceManagement
from sitewhere_tpu_torch.services.replication import (
    RegistryReplicator,
    read_state_topic,
)
from sitewhere_tpu_torch.services.snapshot import StoreSnapshotter

logger = logging.getLogger(__name__)


class DeviceManagementEngine(TenantEngine):
    """Per-tenant device registry + the hot-path registration mask."""

    def __init__(self, service: "DeviceManagementService", tenant: TenantConfig):
        super().__init__(service, tenant)
        self.spi = InMemoryDeviceManagement()
        # dense boolean mask over device indices; grown on demand.
        self._registered = np.zeros(1024, dtype=bool)
        self._snapshotter = None
        self._replicator = None
        self._wal = None
        self._wal_max_seq = -1
        self.restored_from = None  # "bus-replay" | "snapshot+wal" | None

    def _replicate_enabled(self, cfg) -> bool:
        """Replicated tenant state (services/replication.py): tenant
        `device-management: {replicate}` wins, then the instance
        setting; fleet workers default ON — hermetic adoption is the
        point of the fleet (docs/FLEET.md fencing protocol)."""
        if "replicate" in cfg:
            return bool(cfg["replicate"])
        settings = self.runtime.settings
        if settings.registry_replication is not None:
            return bool(settings.registry_replication)
        return bool(settings.fleet_managed)

    async def _do_initialize(self, monitor) -> None:
        cfg = self.tenant.section("device-management", {})
        settings = self.runtime.settings
        data_dir = cfg.get("data_dir", settings.data_dir)
        replicate = self._replicate_enabled(cfg)
        path = None
        if data_dir:
            tdir = os.path.join(data_dir, "tenants", self.tenant_id)
            os.makedirs(tdir, exist_ok=True)
            path = os.path.join(tdir, "registry.snap")
            if self._wal is None or self._wal.closed:
                # restart() re-runs this hook on the same object after a
                # stop closed the WAL — a dead handle here would fail
                # every append (silently regressing the crash bound to
                # the snapshot interval): reopen
                self._wal = WriteAheadLog(
                    os.path.join(tdir, "registry.wal"))

        # -- restore: the bus is the source of truth when replicating --
        # (a worker needs nothing but the wire bus to adopt correctly);
        # local snapshot + WAL cover the single-node restart where the
        # broker's topics died with the host — crash bound = the WAL's
        # last appended record, not the snapshot interval
        bus_snap, bus_muts = (None, [])
        if replicate:
            if self.runtime.faults is not None:
                # chaos seam: the replay path itself must heal (the
                # engine restarts under the tenant-start isolation)
                await self.runtime.faults.acheck("fence.adopt")
            bus_snap, bus_muts = await read_state_topic(
                self.runtime, self.tenant_id,
                reader_tag=self.runtime.fence.worker_id or "adopt")
        if bus_snap is not None or bus_muts:
            muts = bus_muts
            if bus_snap is not None:
                self.spi.restore_snapshot(bus_snap["snapshot"])
            self.restored_from = "bus-replay"
            if self._wal is not None:
                # the bus state just superseded whatever local history
                # this worker kept from a PREVIOUS ownership of the
                # tenant — stale WAL records left after an unclean
                # release must never replay into a later local restore
                # (the snapshotter's first tick rewrites the local
                # snapshot within interval_s)
                try:
                    self._wal.reset()
                except OSError:
                    logger.warning(
                        "device-management[%s]: stale-WAL reset failed",
                        self.tenant_id, exc_info=True)
        else:
            snap = load_snapshot(path) if path else None
            snap_seq = int(snap.get("seq", 0)) if snap else 0
            if snap is not None:
                self.spi.restore_snapshot(snap)
            muts = []
            if self._wal is not None:
                for payload in self._wal.replay():
                    try:
                        rec = codec.decode(payload)
                    except Exception:  # noqa: BLE001 - torn/corrupt tail
                        break
                    if int(rec.get("seq", 0)) > snap_seq:
                        muts.append(rec)
            self.restored_from = ("snapshot+wal"
                                  if snap is not None or muts else None)
        replayed = 0
        if muts:
            for rec in sorted(muts, key=lambda m: int(m.get("seq", 0))):
                try:
                    self.spi.apply_journal(rec.get("op", ""),
                                           rec.get("table", ""),
                                           rec.get("entity"))
                    replayed += 1
                except Exception:  # noqa: BLE001 - one bad record ≠ no state
                    logger.warning("device-management[%s]: journal record "
                                   "%s failed to apply; skipping",
                                   self.tenant_id, rec.get("seq"),
                                   exc_info=True)
            self.spi.mutations = max(
                self.spi.mutations,
                max(int(m.get("seq", 0)) for m in muts))
            self.spi.reindex()
        if replayed:
            self.runtime.metrics.counter("fence.replays").inc(replayed)
        if self.restored_from is not None:
            # rebuild the hot-path mask from restored entities — status
            # included: a device deactivated before the crash must not
            # resurrect as registered
            self._registered[:] = False
            for d in self.spi.devices.by_id.values():
                self._ensure_mask(d.index)
                self._registered[d.index] = d.status == "active"
            logger.info("device-management[%s]: restored %d devices via "
                        "%s (%d journal records replayed)", self.tenant_id,
                        self.spi.device_count(), self.restored_from,
                        replayed)

        if path and self._snapshotter is None:  # restart(): never two loops
            self._snapshotter = StoreSnapshotter(
                "registry-snapshotter", path,
                lambda: self.spi.mutations, self.spi.to_snapshot,
                interval_s=cfg.get("snapshot_interval_s", 1.0),
                on_saved=self._on_snapshot_saved)
            self.add_child(self._snapshotter)
        if replicate and self._replicator is None:
            self._replicator = RegistryReplicator(
                self, snapshot_every=cfg.get("replicate_snapshot_every",
                                             64))
            self.add_child(self._replicator)
        # journal hook LAST: restore/replay above must not re-journal
        if replicate or self._wal is not None:
            self.spi.journal = self._journal

    def _journal(self, seq: int, op: str, table: str, entity) -> None:
        """SPI mutation hook: WAL append (crash bound = last appended
        record) + replicated-state publish via the replicator."""
        if self._wal is not None:
            try:
                self._wal.append(codec.encode(
                    {"seq": seq, "op": op, "table": table,
                     "entity": entity}))
                self._wal_max_seq = seq
                self.runtime.metrics.counter("fence.wal_appends").inc()
            except Exception:  # noqa: BLE001 - durability is an appendix
                logger.warning("device-management[%s]: WAL append failed",
                               self.tenant_id, exc_info=True)
        if self._replicator is not None:
            self._replicator.enqueue(seq, op, table, entity)

    @property
    def snapshot_current(self) -> bool:
        """Whether the local registry snapshot covers every mutation."""
        return (self._snapshotter is not None
                and self._snapshotter.saved_epoch >= self.spi.mutations)

    def _on_snapshot_saved(self, epoch: int) -> None:
        """A persisted snapshot covers mutations ≤ epoch: WAL records
        are obsolete once every appended seq is covered. Guarded for a
        closed WAL (a late snapshotter write racing the stop path): a
        closed WAL raises OSError, never AttributeError."""
        if self._wal is not None and not self._wal.closed \
                and epoch >= self._wal_max_seq:
            try:
                self._wal.reset()
            except OSError:
                logger.warning("device-management[%s]: WAL reset failed",
                               self.tenant_id, exc_info=True)

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        if self._snapshotter is not None:
            self._snapshotter.save_now()  # clean shutdown loses nothing
        if self._wal is not None:
            self._wal.close()

    # -- hot path ----------------------------------------------------------

    def registered_mask(self, indices: np.ndarray) -> np.ndarray:
        """Vectorized 'is this device index registered & active' check.

        Never grows storage from untrusted input: indices beyond the mask
        (which covers every index ever issued) are simply False — a hostile
        4-billion device id in a wire batch costs nothing.
        """
        idx = indices.astype(np.int64, copy=False)
        in_range = idx < self._registered.shape[0]
        safe = np.where(in_range, idx, 0)
        return self._registered[safe] & in_range

    def _ensure_mask(self, max_index: int) -> None:
        n = self._registered.shape[0]
        if max_index < n:
            return
        while n <= max_index:
            n *= 2
        grown = np.zeros(n, dtype=bool)
        grown[: self._registered.shape[0]] = self._registered
        self._registered = grown

    # -- registry ops (delegate to SPI, keep mask in sync) -----------------

    def create_device(self, device: Device) -> Device:
        device = self.spi.create_device(device)
        self._ensure_mask(device.index)
        self._registered[device.index] = True
        return device

    def delete_device(self, id: str) -> Optional[Device]:
        device = self.spi.delete_device(id)
        if device is not None and device.index < self._registered.shape[0]:
            self._registered[device.index] = False
        return device

    def set_device_status(self, id: str, status: str) -> Optional[Device]:
        device = self.spi.get_device(id)
        if device is None:
            return None
        device = self.spi.update_device(dataclasses.replace(device, status=status))
        self._registered[device.index] = status == "active"
        return device

    def bootstrap_fleet(self, device_type: DeviceType, count: int,
                        token_prefix: str = "dev",
                        area_id: Optional[str] = None) -> list[Device]:
        """Bulk-create `count` devices + active assignments (dataset
        template analog, [SURVEY.md §3.5]; also the simulator's fixture)."""
        if self.spi.get_device_type(device_type.id) is None:
            self.spi.create_device_type(device_type)
        devices = []
        for i in range(count):
            d = self.create_device(Device(token=f"{token_prefix}-{i}",
                                          device_type_id=device_type.id))
            self.spi.create_device_assignment(
                DeviceAssignment(device_id=d.id, area_id=area_id,
                                 token=f"{token_prefix}-{i}-a"))
            devices.append(d)
        return devices

    def __getattr__(self, name):
        # non-overridden SPI surface passes straight through
        return getattr(self.spi, name)


class DeviceManagementService(Service):
    identifier = "device-management"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> DeviceManagementEngine:
        return DeviceManagementEngine(self, tenant)

    def management(self, tenant_id: str) -> DeviceManagementEngine:
        """The in-proc ApiChannel equivalent [SURVEY.md §2.1 gRPC plumbing]."""
        return self.engine(tenant_id)  # type: ignore[return-value]
