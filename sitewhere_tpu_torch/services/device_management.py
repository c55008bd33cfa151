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
from typing import Optional

import numpy as np

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.model import (
    Device,
    DeviceAssignment,
    DeviceType,
)
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine
from sitewhere_tpu_torch.persistence.memory import InMemoryDeviceManagement
from sitewhere_tpu_torch.utils.roadmap import not_ported


class DeviceManagementEngine(TenantEngine):
    """Per-tenant device registry + the hot-path registration mask."""

    def __init__(self, service: "DeviceManagementService", tenant: TenantConfig):
        super().__init__(service, tenant)
        cfg = tenant.section("device-management", {})
        settings = self.runtime.settings
        # the registry is RAM-only here: snapshots + WAL (data_dir) and
        # the replicated registry-state topic are not ported yet
        if cfg.get("data_dir", settings.data_dir):
            raise not_ported("registry snapshots and WAL (data_dir)",
                             "A.1.3")
        if cfg.get("replicate", settings.registry_replication
                   if settings.registry_replication is not None
                   else settings.fleet_managed):
            raise not_ported("registry replication", "A.1.3")
        self.spi = InMemoryDeviceManagement()
        # dense boolean mask over device indices; grown on demand.
        self._registered = np.zeros(1024, dtype=bool)

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
