"""asset-management service (reference: service-asset-management,
[SURVEY.md §2.2]): asset types + assets referenced by assignments."""

from __future__ import annotations

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine
from sitewhere_tpu_torch.persistence.memory import InMemoryAssetManagement


class AssetManagementEngine(TenantEngine):
    def __init__(self, service: "AssetManagementService", tenant: TenantConfig):
        super().__init__(service, tenant)
        self.spi = InMemoryAssetManagement()
        self._snapshotter = None

    async def _do_initialize(self, monitor) -> None:
        cfg = self.tenant.section("asset-management", {})
        data_dir = cfg.get("data_dir", self.runtime.settings.data_dir)
        if not data_dir:
            return
        import os

        from sitewhere_tpu_torch.persistence.durable import load_snapshot
        from sitewhere_tpu_torch.services.snapshot import StoreSnapshotter

        tdir = os.path.join(data_dir, "tenants", self.tenant_id)
        os.makedirs(tdir, exist_ok=True)
        path = os.path.join(tdir, "assets.snap")
        snap = load_snapshot(path)
        if snap is not None:
            self.spi.restore_snapshot(snap)
        if self._snapshotter is None:
            self._snapshotter = StoreSnapshotter(
                "asset-snapshotter", path,
                lambda: self.spi.mutations, self.spi.to_snapshot,
                interval_s=cfg.get("snapshot_interval_s", 1.0))
            self.add_child(self._snapshotter)

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        if self._snapshotter is not None:
            self._snapshotter.save_now()

    def __getattr__(self, name):
        return getattr(self.spi, name)


class AssetManagementService(Service):
    identifier = "asset-management"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> AssetManagementEngine:
        return AssetManagementEngine(self, tenant)

    def management(self, tenant_id: str) -> AssetManagementEngine:
        return self.engine(tenant_id)  # type: ignore[return-value]
