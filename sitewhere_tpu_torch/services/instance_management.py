"""instance-management service (reference: service-instance-management,
[SURVEY.md §2.2]): instance bootstrap, user management, tenant
management, JWT auth — and the host of the REST facade (rest/api.py).

Global (not multitenant): users and tenants are instance-scoped, exactly
as in the reference. Tenant CRUD drives the runtime's tenant-model-update
broadcast so every service's engine manager reacts [SURVEY.md §3.5].
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.model import Tenant, User, new_id
from sitewhere_tpu_torch.kernel.security import (
    ALL_AUTHORITIES,
    AuthContext,
    TokenManagement,
)
from sitewhere_tpu_torch.kernel.service import Service
from sitewhere_tpu_torch.persistence.memory import (
    InMemoryTenantManagement,
    InMemoryUserManagement,
)

logger = logging.getLogger(__name__)


class InstanceManagementService(Service):
    identifier = "instance-management"
    multitenant = False

    def __init__(self, runtime, *, serve_rest: bool = True):
        super().__init__(runtime)
        self.users = InMemoryUserManagement()
        self.tenant_store = InMemoryTenantManagement()
        self.tokens = TokenManagement(
            runtime.settings.jwt_secret,
            expiration_s=runtime.settings.jwt_expiration_s)
        self._bootstrap_admin = ("admin", "password")  # overridable pre-start
        self._restored_tenants: list[TenantConfig] = []
        self._snapshotters: list = []
        self.rest = None
        if serve_rest:
            from sitewhere_tpu_torch.rest.api import RestServer

            self.rest = RestServer(runtime)
            self.add_child(self.rest)

    async def _do_initialize(self, monitor) -> None:
        # durability: restore users + tenants (entities AND runtime
        # TenantConfigs) BEFORE the admin bootstrap, so a restored admin
        # (possibly with a changed password) is never overwritten and
        # restored tenants respin once the runtime is up
        self._restored_tenants: list[TenantConfig] = []
        # NOTE: self._snapshotters is deliberately NOT reset here —
        # restart() re-runs _do_initialize and a reset would defeat the
        # duplicate-loop guard below (two loops → interleaved tmp-file
        # writes → torn snapshot)
        settings = self.runtime.settings
        if settings.data_dir:
            import os

            from sitewhere_tpu_torch.persistence.durable import load_snapshot
            from sitewhere_tpu_torch.services.snapshot import StoreSnapshotter

            idir = os.path.join(settings.data_dir, "instance")
            os.makedirs(idir, exist_ok=True)
            upath = os.path.join(idir, "users.snap")
            tpath = os.path.join(idir, "tenants.snap")
            usnap = load_snapshot(upath)
            if usnap is not None:
                self.users.restore_snapshot(usnap)
            tsnap = load_snapshot(tpath)
            if tsnap is not None:
                self.tenant_store.restore_snapshot(tsnap)
                self._restored_tenants = list(tsnap.get("configs", []))
                logger.info("instance-management: restored %d users, "
                            "%d tenants", len(self.users.list_users()),
                            len(self._restored_tenants))

            def collect_tenants() -> dict:
                snap = self.tenant_store.to_snapshot()
                snap["configs"] = list(self.runtime.tenants.values())
                return snap

            if not self._snapshotters:  # restart(): never two loops
                self._snapshotters = [
                    StoreSnapshotter("users-snapshotter", upath,
                                     lambda: self.users.mutations,
                                     self.users.to_snapshot),
                    StoreSnapshotter(
                        "tenants-snapshotter", tpath,
                        # sum of two MONOTONIC counters: store CRUD and
                        # runtime config-map changes (add/update/remove
                        # all bump tenant_epoch)
                        lambda: (self.tenant_store.mutations
                                 + self.runtime.tenant_epoch),
                        collect_tenants),
                ]
                for s in self._snapshotters:
                    self.add_child(s)
        # instance bootstrap (reference: instance templates seed an admin)
        username, password = self._bootstrap_admin
        if self.users.get_user_by_username(username) is None:
            self.users.create_user(
                User(username=username, first_name="Admin",
                     authorities=ALL_AUTHORITIES), password)

    async def _do_start(self, monitor) -> None:
        await super()._do_start(monitor)
        if self._restored_tenants:
            import asyncio

            self._respin_task = asyncio.create_task(
                self._respin_restored(), name=f"{self.path}/respin")

    async def _respin_restored(self) -> None:
        """Re-add restored tenants once EVERY service is started (their
        tenant-update consumers must be live to build engines)."""
        import asyncio

        from sitewhere_tpu_torch.kernel.lifecycle import LifecycleStatus

        terminal = (LifecycleStatus.INITIALIZATION_ERROR,
                    LifecycleStatus.LIFECYCLE_ERROR,
                    LifecycleStatus.STOPPING, LifecycleStatus.STOPPED,
                    LifecycleStatus.TERMINATED)
        while self.runtime.status != LifecycleStatus.STARTED:
            if self.runtime.status in terminal:
                logger.warning("respin abandoned: runtime is %s",
                               self.runtime.status.value)
                return
            await asyncio.sleep(0.05)
        for cfg in self._restored_tenants:
            if cfg.tenant_id in self.runtime.tenants:
                continue
            try:
                await self.runtime.add_tenant(cfg)
                logger.info("instance-management: respun tenant %s "
                            "from snapshot", cfg.tenant_id)
            except Exception:  # noqa: BLE001 - one tenant can't block the rest
                logger.exception("respin of restored tenant %s failed",
                                 cfg.tenant_id)

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        task = getattr(self, "_respin_task", None)
        if task is not None and not task.done():
            task.cancel()
        for s in self._snapshotters:
            s.save_now()  # clean shutdown loses nothing

    # -- auth --------------------------------------------------------------

    def authenticate(self, username: str, password: str) -> Optional[str]:
        """Returns a JWT, or None."""
        user = self.users.authenticate(username, password)
        if user is None:
            return None
        return self.tokens.issue(user.username, user.authorities)

    def validate(self, token: str) -> Optional[AuthContext]:
        return self.tokens.validate(token)

    # -- users -------------------------------------------------------------

    def create_user(self, username: str, password: str,
                    authorities: tuple[str, ...] = ("REST",),
                    first_name: str = "", last_name: str = "") -> User:
        if self.users.get_user_by_username(username) is not None:
            raise ValueError(f"user {username!r} exists")
        return self.users.create_user(
            User(username=username, authorities=tuple(authorities),
                 first_name=first_name, last_name=last_name), password)

    # -- tenants -----------------------------------------------------------

    async def create_tenant(self, tenant_id: str, name: str = "",
                            sections: Optional[dict] = None,
                            authorized_user_ids: tuple[str, ...] = (),
                            template: Optional[str] = None) -> Tenant:
        """Create + spin a tenant; `template` names a dataset initializer
        (kernel/templates.py) that contributes default config sections
        and seeds sample data once the engines are up [SURVEY.md §3.5]."""
        if self.tenant_store.get_tenant_by_token(tenant_id) is not None:
            raise ValueError(f"tenant {tenant_id!r} exists")
        tpl = None
        if template:
            from sitewhere_tpu_torch.kernel.templates import (
                get_template,
                merged_sections,
            )

            tpl = get_template(template)
            sections = merged_sections(tpl, sections)
        tenant = self.tenant_store.create_tenant(Tenant(
            token=tenant_id, name=name or tenant_id,
            auth_token=new_id(),
            authorized_user_ids=tuple(authorized_user_ids)))
        await self.runtime.add_tenant(TenantConfig(
            tenant_id=tenant_id, name=tenant.name,
            authorized_user_ids=tuple(authorized_user_ids),
            sections=sections or {}))
        if tpl is not None and tpl.seed is not None:
            await tpl.seed(self.runtime, tenant_id)
        return tenant

    async def update_tenant(self, tenant_id: str,
                            sections: Optional[dict] = None,
                            name: Optional[str] = None) -> Tenant:
        tenant = self.tenant_store.get_tenant_by_token(tenant_id)
        if tenant is None:
            raise KeyError(f"unknown tenant {tenant_id!r}")
        if name is not None:
            tenant = self.tenant_store.update_tenant(
                dataclasses.replace(tenant, name=name))
        current = self.runtime.tenants.get(tenant_id)
        cfg = TenantConfig(
            tenant_id=tenant_id, name=tenant.name,
            authorized_user_ids=tenant.authorized_user_ids,
            sections=sections if sections is not None
            else (current.sections if current else {}))
        await self.runtime.update_tenant(cfg)
        return tenant

    async def delete_tenant(self, tenant_id: str) -> Optional[Tenant]:
        tenant = self.tenant_store.get_tenant_by_token(tenant_id)
        if tenant is None:
            return None
        await self.runtime.remove_tenant(tenant_id)
        return self.tenant_store.delete_tenant(tenant.id)

    def list_tenants(self) -> list[Tenant]:
        return self.tenant_store.list_tenants()

    def get_tenant(self, tenant_id: str) -> Optional[Tenant]:
        return self.tenant_store.get_tenant_by_token(tenant_id)
