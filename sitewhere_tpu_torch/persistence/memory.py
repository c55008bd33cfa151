"""In-memory SPI implementations (the default datastore + test double).

The reference backs each SPI with MongoDB/RDB implementations
(`MongoDeviceManagement` etc., [SURVEY.md §2.2]); per the rebuild test
strategy [SURVEY.md §4] every store also needs an in-memory fake behind
the same protocol — here the fake IS the default store, and external
adapters are the later addition.

All methods are synchronous and non-blocking (dict/array ops), called from
the single service event loop; the telemetry store handles its own locking
for cross-thread training snapshots.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional, Sequence

import numpy as np

from sitewhere_tpu_torch.domain.batch import AlertBatch, LocationBatch, MeasurementBatch
from sitewhere_tpu_torch.domain.events import (
    DeviceAlert,
    DeviceCommandInvocation,
    DeviceCommandResponse,
    DeviceEvent,
    DeviceLocation,
    DeviceMeasurement,
    DeviceStateChange,
)
from sitewhere_tpu_torch.domain.model import (
    Area,
    Asset,
    AssetType,
    BatchElement,
    BatchOperation,
    Customer,
    Device,
    DeviceAssignment,
    DeviceAssignmentStatus,
    DeviceCommand,
    DeviceGroup,
    DeviceGroupElement,
    DeviceStatus,
    DeviceType,
    Schedule,
    ScheduledJob,
    Tenant,
    User,
    Zone,
)
from sitewhere_tpu_torch.persistence.durable import (
    RT_COLD,
    RT_LOCATIONS,
    RT_MEASUREMENTS,
)
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore


def _page(items: list, page: int, page_size: int) -> list:
    start = (page - 1) * page_size
    return items[start:start + page_size]


class _EntityTable:
    """id + token indexed table for one entity type. `name` + the
    3-arg `on_mutate(op, table, entity)` feed the mutation journal
    (replicated tenant state, services/replication.py)."""

    def __init__(self, on_mutate=None, name: str = "") -> None:
        self.by_id: dict[str, object] = {}
        self.by_token: dict[str, str] = {}
        self.name = name
        self._on_mutate = on_mutate

    def put(self, entity) -> object:
        self.by_id[entity.id] = entity
        if entity.token:
            self.by_token[entity.token] = entity.id
        if self._on_mutate is not None:
            self._on_mutate("put", self.name, entity)
        return entity

    def get(self, id: str):
        return self.by_id.get(id)

    def get_by_token(self, token: str):
        id = self.by_token.get(token)
        return self.by_id.get(id) if id else None

    def delete(self, id: str):
        entity = self.by_id.pop(id, None)
        if entity is not None and getattr(entity, "token", ""):
            self.by_token.pop(entity.token, None)
        if entity is not None and self._on_mutate is not None:
            self._on_mutate("del", self.name, entity)
        return entity

    def values(self) -> list:
        return sorted(self.by_id.values(), key=lambda e: e.created_date)


class _TableSnapshotMixin:
    """Durability contract shared by the entity stores: `_TABLES` names
    the `_EntityTable` attributes snapshotted/restored as a unit, and
    `mutations` is the debounce epoch (persistence/durable.py snapshots
    via services/snapshot.StoreSnapshotter). Restore merges by id and
    rebuilds token indexes; subclasses extend for derived state.

    Replication hooks (services/replication.py): `journal`, when set,
    receives `(seq, op, table, entity)` for every entity write/delete —
    the mutation stream the WAL and the per-tenant registry-state topic
    carry; `apply_journal` replays one such record (raw table writes,
    NO journaling, no derived-index maintenance — callers reindex once
    after the full replay). Snapshots carry `seq` (= `mutations` at
    collect time) so replay from any source is bounded: only records
    with a newer seq apply."""

    _TABLES: tuple = ()
    mutations: int = 0
    journal = None     # callable(seq, op, table, entity) | None

    def _mutated(self, op: str = "", table: str = "", entity=None) -> None:
        self.mutations += 1
        cb = self.journal
        if cb is not None and op:
            cb(self.mutations, op, table, entity)

    def _bump_mutations(self) -> None:
        # info-free mutation (derived/dict-only state): bumps the
        # snapshot debounce epoch but emits no journal record — the
        # next interleaved snapshot carries the change
        self._mutated()

    def to_snapshot(self) -> dict:
        return {"seq": self.mutations,
                "tables": {name: list(getattr(self, name).by_id.values())
                           for name in self._TABLES}}

    def restore_snapshot(self, snap: dict) -> None:
        for name in self._TABLES:
            table = getattr(self, name)
            for entity in snap["tables"].get(name, []):
                table.by_id[entity.id] = entity
                if getattr(entity, "token", ""):
                    table.by_token[entity.token] = entity.id
        self.mutations = max(self.mutations, int(snap.get("seq", 0)))

    def apply_journal(self, op: str, table: str, entity) -> None:
        """Replay one journaled mutation (replicated-state adoption)."""
        t = getattr(self, table, None)
        if not isinstance(t, _EntityTable):
            return
        if op == "put":
            t.by_id[entity.id] = entity
            if getattr(entity, "token", ""):
                t.by_token[entity.token] = entity.id
        elif op == "del":
            t.by_id.pop(entity.id, None)
            if getattr(entity, "token", ""):
                t.by_token.pop(entity.token, None)


class InMemoryDeviceManagement(_TableSnapshotMixin):
    """Implements DeviceManagementSPI for one tenant.

    TPU-first detail: devices get dense indices from a monotonically
    increasing counter; `index_to_device_id` is the reverse map used when
    scored batches are materialized into alerts.
    """

    # entity tables snapshotted/restored as a unit (order is cosmetic;
    # restore rebuilds all derived indexes from entity contents)
    _TABLES = ("device_types", "commands", "statuses", "devices",
               "assignments", "groups", "customers", "areas", "zones")

    def __init__(self) -> None:
        # mutation epoch + journal (mixin): every entity write/delete
        # bumps the snapshotter's debounce epoch AND, when a journal is
        # attached (replicated tenant state), emits a (seq, op, table,
        # entity) record the WAL / registry-state topic carry
        mut = self._mutated
        self.device_types = _EntityTable(mut, "device_types")
        self.commands = _EntityTable(mut, "commands")
        self.statuses = _EntityTable(mut, "statuses")
        self.devices = _EntityTable(mut, "devices")
        self.assignments = _EntityTable(mut, "assignments")
        self.groups = _EntityTable(mut, "groups")
        self.group_elements: dict[str, list[DeviceGroupElement]] = {}
        self.customers = _EntityTable(mut, "customers")
        self.areas = _EntityTable(mut, "areas")
        self.zones = _EntityTable(mut, "zones")
        self._next_index = 0
        self._token_to_index: dict[str, int] = {}
        self._index_to_device_id: dict[int, str] = {}
        self._active_assignment_by_device: dict[str, list[str]] = {}

    # -- durability (persistence/durable.py snapshots) ---------------------

    def to_snapshot(self) -> dict:
        """Whole-store state as codec-serializable primitives + entities."""
        snap = super().to_snapshot()
        snap["group_elements"] = {gid: list(els) for gid, els
                                  in self.group_elements.items()}
        snap["next_index"] = self._next_index
        return snap

    def restore_snapshot(self, snap: dict) -> None:
        """Rebuild every table and derived index from `to_snapshot()`
        output. Active-assignment lists are derived from assignment
        status; device index maps from the entities themselves.
        Idempotent: derived maps are rebuilt from scratch so an engine
        restart() re-running initialization never duplicates entries."""
        super().restore_snapshot(snap)
        self.group_elements = {gid: list(els) for gid, els
                               in snap.get("group_elements", {}).items()}
        self._next_index = int(snap.get("next_index", 0))
        self.reindex()

    def reindex(self) -> None:
        """Rebuild every derived map from entity contents — after a
        snapshot restore AND after a journal replay (apply_journal
        writes raw tables only, so one reindex covers any mix)."""
        self._token_to_index = {}
        self._index_to_device_id = {}
        self._active_assignment_by_device = {}
        for d in self.devices.by_id.values():
            if d.token:
                self._token_to_index[d.token] = d.index
            self._index_to_device_id[d.index] = d.id
            self._next_index = max(self._next_index, d.index + 1)
        for a in self.assignments.by_id.values():
            if a.status == DeviceAssignmentStatus.ACTIVE:
                self._active_assignment_by_device.setdefault(
                    a.device_id, []).append(a.id)

    def apply_journal(self, op: str, table: str, entity) -> None:
        if op == "gel":
            # group-element append: `table` is the group id, `entity`
            # the appended element list (add_device_group_elements)
            self.group_elements.setdefault(table, []).extend(entity)
            return
        super().apply_journal(op, table, entity)

    # -- device types ------------------------------------------------------

    def create_device_type(self, dt: DeviceType) -> DeviceType:
        return self.device_types.put(dt)

    def get_device_type(self, id: str) -> Optional[DeviceType]:
        return self.device_types.get(id)

    def get_device_type_by_token(self, token: str) -> Optional[DeviceType]:
        return self.device_types.get_by_token(token)

    def update_device_type(self, dt: DeviceType) -> DeviceType:
        dt = dataclasses.replace(dt, updated_date=time.time())
        return self.device_types.put(dt)

    def delete_device_type(self, id: str) -> Optional[DeviceType]:
        return self.device_types.delete(id)

    def list_device_types(self, page: int = 1, page_size: int = 100) -> list[DeviceType]:
        return _page(self.device_types.values(), page, page_size)

    def create_device_command(self, cmd: DeviceCommand) -> DeviceCommand:
        return self.commands.put(cmd)

    def get_device_command(self, id: str) -> Optional[DeviceCommand]:
        return self.commands.get(id)

    def get_device_command_by_token(self, device_type_id: str,
                                    token: str) -> Optional[DeviceCommand]:
        cmd = self.commands.get_by_token(token)
        if cmd is not None and cmd.device_type_id == device_type_id:
            return cmd
        return None

    def list_device_commands(self, device_type_id: str) -> list[DeviceCommand]:
        return [c for c in self.commands.values() if c.device_type_id == device_type_id]

    def find_device_command_by_token(self, token: str) -> Optional[DeviceCommand]:
        """Token-only lookup (REST batch/invocation convenience)."""
        return self.commands.get_by_token(token)

    def create_device_status(self, status: DeviceStatus) -> DeviceStatus:
        return self.statuses.put(status)

    def list_device_statuses(self, device_type_id: str) -> list[DeviceStatus]:
        return [s for s in self.statuses.values() if s.device_type_id == device_type_id]

    # -- devices -----------------------------------------------------------

    def create_device(self, device: Device) -> Device:
        if device.token and self.devices.get_by_token(device.token):
            raise ValueError(f"device token {device.token!r} already exists")
        if device.index < 0:
            device = dataclasses.replace(device, index=self._next_index)
        self._next_index = max(self._next_index, device.index + 1)
        self.devices.put(device)
        if device.token:
            self._token_to_index[device.token] = device.index
        self._index_to_device_id[device.index] = device.id
        return device

    def get_device(self, id: str) -> Optional[Device]:
        return self.devices.get(id)

    def get_device_by_token(self, token: str) -> Optional[Device]:
        return self.devices.get_by_token(token)

    def get_device_by_index(self, index: int) -> Optional[Device]:
        id = self._index_to_device_id.get(index)
        return self.devices.get(id) if id else None

    def update_device(self, device: Device) -> Device:
        device = dataclasses.replace(device, updated_date=time.time())
        return self.devices.put(device)

    def delete_device(self, id: str) -> Optional[Device]:
        device = self.devices.delete(id)
        if device is not None:
            self._token_to_index.pop(device.token, None)
            self._index_to_device_id.pop(device.index, None)
        return device

    def list_devices(self, device_type_id: Optional[str] = None,
                     page: int = 1, page_size: int = 100) -> list[Device]:
        items = self.devices.values()
        if device_type_id is not None:
            items = [d for d in items if d.device_type_id == device_type_id]
        return _page(items, page, page_size)

    def device_count(self) -> int:
        return len(self.devices.by_id)

    # -- assignments -------------------------------------------------------

    def create_device_assignment(self, a: DeviceAssignment) -> DeviceAssignment:
        device = self.devices.get(a.device_id)
        if device is None:
            raise ValueError(f"assignment references unknown device {a.device_id}")
        if not a.device_type_id:
            a = dataclasses.replace(a, device_type_id=device.device_type_id)
        self.assignments.put(a)
        self._active_assignment_by_device.setdefault(a.device_id, []).append(a.id)
        return a

    def get_device_assignment(self, id: str) -> Optional[DeviceAssignment]:
        return self.assignments.get(id)

    def get_device_assignment_by_token(self, token: str) -> Optional[DeviceAssignment]:
        return self.assignments.get_by_token(token)

    def get_active_assignments_for_device(self, device_id: str) -> list[DeviceAssignment]:
        out = []
        for aid in self._active_assignment_by_device.get(device_id, []):
            a = self.assignments.get(aid)
            if a is not None and a.status == DeviceAssignmentStatus.ACTIVE:
                out.append(a)
        return out

    def update_device_assignment(self, a: DeviceAssignment) -> DeviceAssignment:
        a = dataclasses.replace(a, updated_date=time.time())
        return self.assignments.put(a)

    def release_device_assignment(self, id: str) -> Optional[DeviceAssignment]:
        a = self.assignments.get(id)
        if a is None:
            return None
        a = dataclasses.replace(a, status=DeviceAssignmentStatus.RELEASED,
                                released_date=time.time(), updated_date=time.time())
        self.assignments.put(a)
        ids = self._active_assignment_by_device.get(a.device_id, [])
        if id in ids:
            ids.remove(id)
        return a

    def list_device_assignments(self, device_id: Optional[str] = None,
                                customer_id: Optional[str] = None,
                                area_id: Optional[str] = None,
                                asset_id: Optional[str] = None,
                                page: int = 1, page_size: int = 100) -> list[DeviceAssignment]:
        items = self.assignments.values()
        if device_id is not None:
            items = [a for a in items if a.device_id == device_id]
        if customer_id is not None:
            items = [a for a in items if a.customer_id == customer_id]
        if area_id is not None:
            items = [a for a in items if a.area_id == area_id]
        if asset_id is not None:
            items = [a for a in items if a.asset_id == asset_id]
        return _page(items, page, page_size)

    # -- groups ------------------------------------------------------------

    def create_device_group(self, g: DeviceGroup) -> DeviceGroup:
        return self.groups.put(g)

    def get_device_group(self, id: str) -> Optional[DeviceGroup]:
        return self.groups.get(id)

    def get_device_group_by_token(self, token: str) -> Optional[DeviceGroup]:
        return self.groups.get_by_token(token)

    def delete_device_group(self, id: str) -> Optional[DeviceGroup]:
        self.group_elements.pop(id, None)
        return self.groups.delete(id)

    def list_device_groups(self, page: int = 1, page_size: int = 100) -> list[DeviceGroup]:
        return _page(self.groups.values(), page, page_size)

    def add_device_group_elements(self, group_id: str,
                                  elements: Sequence[DeviceGroupElement]) -> list[DeviceGroupElement]:
        stored = self.group_elements.setdefault(group_id, [])
        added = [dataclasses.replace(el, group_id=group_id)
                 for el in elements]
        stored.extend(added)
        # dict-only write (no _EntityTable): journal the appended slice
        # under the "gel" op so replicated adopters replay it too
        self._mutated("gel", group_id, added)
        return list(stored)

    def list_device_group_elements(self, group_id: str) -> list[DeviceGroupElement]:
        return list(self.group_elements.get(group_id, []))

    def expand_group_devices(self, group_id: str,
                             _seen: Optional[set] = None) -> list[Device]:
        """Recursively resolve a group to its devices (nested groups ok)."""
        seen = _seen if _seen is not None else set()
        if group_id in seen:
            return []
        seen.add(group_id)
        out: list[Device] = []
        for el in self.group_elements.get(group_id, []):
            if el.device_id:
                d = self.devices.get(el.device_id)
                if d is not None:
                    out.append(d)
            elif el.nested_group_id:
                out.extend(self.expand_group_devices(el.nested_group_id, seen))
        return out

    # -- customers / areas / zones ----------------------------------------

    def create_customer(self, c: Customer) -> Customer:
        return self.customers.put(c)

    def get_customer(self, id: str) -> Optional[Customer]:
        return self.customers.get(id)

    def get_customer_by_token(self, token: str) -> Optional[Customer]:
        return self.customers.get_by_token(token)

    def list_customers(self, page: int = 1, page_size: int = 100) -> list[Customer]:
        return _page(self.customers.values(), page, page_size)

    def create_area(self, a: Area) -> Area:
        return self.areas.put(a)

    def get_area(self, id: str) -> Optional[Area]:
        return self.areas.get(id)

    def get_area_by_token(self, token: str) -> Optional[Area]:
        return self.areas.get_by_token(token)

    def list_areas(self, page: int = 1, page_size: int = 100) -> list[Area]:
        return _page(self.areas.values(), page, page_size)

    def create_zone(self, z: Zone) -> Zone:
        return self.zones.put(z)

    def get_zone(self, id: str) -> Optional[Zone]:
        return self.zones.get(id)

    def get_zone_by_token(self, token: str) -> Optional[Zone]:
        return self.zones.get_by_token(token)

    def list_zones(self, area_id: Optional[str] = None) -> list[Zone]:
        items = self.zones.values()
        if area_id is not None:
            items = [z for z in items if z.area_id == area_id]
        return items

    # -- index mapping (hot path) ------------------------------------------

    def index_of_token(self, token: str) -> int:
        return self._token_to_index.get(token, -1)

    def tokens_to_indices(self, tokens: Sequence[str]) -> list[int]:
        get = self._token_to_index.get
        return [get(t, -1) for t in tokens]

    def max_index(self) -> int:
        return self._next_index


class InMemoryDeviceEventManagement:
    """Implements DeviceEventManagementSPI for one tenant.

    Hot events (measurements/locations) land in the columnar
    `TelemetryStore`; cold events (alerts, invocations, responses, state
    changes) are bounded per-type lists. Query methods materialize
    per-event objects on demand from the columnar store.
    """

    def __init__(self, device_management: InMemoryDeviceManagement,
                 history: int = 1024, cold_retention: int = 100_000,
                 durable=None):
        self.dm = device_management
        self.telemetry = TelemetryStore(history=history)
        self.cold_retention = cold_retention
        self.alerts: list[DeviceAlert] = []
        self.invocations: list[DeviceCommandInvocation] = []
        self.responses: list[DeviceCommandResponse] = []
        self.state_changes: list[DeviceStateChange] = []
        self._events_by_id: dict[str, DeviceEvent] = {}
        # optional spill log (persistence/durable.DurableEventLog):
        # every persisted event is teed to disk; replay happens here,
        # before any consumer runs, so scoring warmup sees recovered
        # history exactly as if the process had never died
        self.durable = durable
        self._replaying = False
        if durable is not None:
            self._replay_durable()

    def _replay_durable(self) -> None:
        from sitewhere_tpu_torch.domain.batch import BatchContext

        ctx = BatchContext(tenant_id="", source="durable-replay")
        self._replaying = True
        try:
            def handler(rtype: int, payload: memoryview) -> None:
                if rtype == RT_MEASUREMENTS:
                    self.add_measurements(
                        MeasurementBatch.decode(payload, ctx))
                elif rtype == RT_LOCATIONS:
                    self.add_locations(LocationBatch.decode(payload, ctx))
                elif rtype == RT_COLD:
                    from sitewhere_tpu_torch.kernel import codec

                    ev = codec.decode(payload)
                    if isinstance(ev, DeviceAlert):
                        self.add_alerts([ev])
                    elif isinstance(ev, DeviceCommandInvocation):
                        self.add_command_invocations([ev])
                    elif isinstance(ev, DeviceCommandResponse):
                        self.add_command_responses([ev])
                    elif isinstance(ev, DeviceStateChange):
                        self.add_state_changes([ev])
            self.durable.replay(handler)
        finally:
            self._replaying = False

    def _spill(self, rtype: int, obj) -> None:
        if self.durable is not None and not self._replaying:
            self.durable.submit(rtype, obj)

    def _trim(self, lst: list) -> None:
        excess = len(lst) - self.cold_retention
        if excess > 0:
            for ev in lst[:excess]:
                self._events_by_id.pop(ev.id, None)
            del lst[:excess]

    def _index_ctx(self, device_index: int) -> dict:
        """assignment context for materialized events (best effort)."""
        device = self.dm.get_device_by_index(device_index)
        if device is None:
            return {"device_id": "", "assignment_id": ""}
        assignments = self.dm.get_active_assignments_for_device(device.id)
        a = assignments[0] if assignments else None
        return {
            "device_id": device.id,
            "assignment_id": a.id if a else "",
            "customer_id": a.customer_id if a else None,
            "area_id": a.area_id if a else None,
            "asset_id": a.asset_id if a else None,
        }

    # -- hot appends -------------------------------------------------------

    def add_measurements(self, batch: MeasurementBatch) -> int:
        n = self.telemetry.append_measurements(batch)
        self._spill(RT_MEASUREMENTS, batch)
        return n

    def add_locations(self, batch: LocationBatch) -> int:
        n = self.telemetry.append_locations(batch)
        self._spill(RT_LOCATIONS, batch)
        return n

    # -- cold appends ------------------------------------------------------

    def add_alerts(self, alerts: Sequence[DeviceAlert]) -> list[DeviceAlert]:
        for a in alerts:
            self.alerts.append(a)
            self._events_by_id[a.id] = a
            self._spill(RT_COLD, a)
        self._trim(self.alerts)
        return list(alerts)

    def add_alert_batch(self, batch: AlertBatch) -> list[DeviceAlert]:
        from sitewhere_tpu_torch.domain.events import AlertLevel
        out = []
        ts = batch.ts if batch.ts is not None else np.full(len(batch), time.time())
        for i in range(len(batch)):
            ctx = self._index_ctx(int(batch.device_index[i]))
            out.append(DeviceAlert(
                source=batch.source, level=AlertLevel(int(batch.level[i])),
                type=batch.type[i] if i < len(batch.type) else "",
                message=batch.message[i] if i < len(batch.message) else "",
                event_date=float(ts[i]), **ctx))
        return self.add_alerts(out)

    def add_command_invocations(self, invocations: Sequence[DeviceCommandInvocation]) -> list[DeviceCommandInvocation]:
        for inv in invocations:
            self.invocations.append(inv)
            self._events_by_id[inv.id] = inv
            self._spill(RT_COLD, inv)
        self._trim(self.invocations)
        return list(invocations)

    def add_command_responses(self, responses: Sequence[DeviceCommandResponse]) -> list[DeviceCommandResponse]:
        for r in responses:
            self.responses.append(r)
            self._events_by_id[r.id] = r
            self._spill(RT_COLD, r)
        self._trim(self.responses)
        return list(responses)

    def add_state_changes(self, changes: Sequence[DeviceStateChange]) -> list[DeviceStateChange]:
        for c in changes:
            self.state_changes.append(c)
            self._events_by_id[c.id] = c
            self._spill(RT_COLD, c)
        self._trim(self.state_changes)
        return list(changes)

    # -- queries -----------------------------------------------------------

    def get_event(self, event_id: str) -> Optional[DeviceEvent]:
        return self._events_by_id.get(event_id)

    def list_measurements(self, device_index: int, mtype: int = 0,
                          start: float = 0.0, end: float = 1e18,
                          limit: int = 1000) -> list[DeviceMeasurement]:
        table = self.telemetry.channel(mtype)
        w = min(limit, table.history)
        devices = np.asarray([device_index])
        vals, valid = table.window(devices, w)
        tss = table.window_ts(devices, w)
        ctx = self._index_ctx(device_index)
        out = []
        for i in range(w):
            if not valid[0, i]:
                continue
            t = float(tss[0, i])
            if start <= t <= end:
                out.append(DeviceMeasurement(
                    name=f"ch{mtype}", value=float(vals[0, i]), event_date=t, **ctx))
        return out

    def list_locations(self, device_index: int, start: float = 0.0,
                       end: float = 1e18, limit: int = 1000) -> list[DeviceLocation]:
        table = self.telemetry.locations
        devices = np.asarray([device_index], np.int64)
        table._ensure_capacity(device_index)
        w = min(limit, table.history, int(table.count[device_index]))
        ctx = self._index_ctx(device_index)
        out = []
        for k in range(w):
            idx = (table.cursor[device_index] - 1 - k) % table.history
            t = float(table.ts[device_index, idx])
            if start <= t <= end:
                out.append(DeviceLocation(
                    latitude=float(table.lat[device_index, idx]),
                    longitude=float(table.lon[device_index, idx]),
                    elevation=float(table.elev[device_index, idx]),
                    event_date=t, **ctx))
        out.reverse()
        return out

    def _filter_cold(self, lst: list, device_index: Optional[int], limit: int) -> list:
        if device_index is None:
            return lst[-limit:]
        device = self.dm.get_device_by_index(device_index)
        if device is None:
            return []
        return [e for e in lst if e.device_id == device.id][-limit:]

    def list_alerts(self, device_index: Optional[int] = None,
                    limit: int = 1000) -> list[DeviceAlert]:
        return self._filter_cold(self.alerts, device_index, limit)

    def list_command_invocations(self, device_index: Optional[int] = None,
                                 limit: int = 1000) -> list[DeviceCommandInvocation]:
        return self._filter_cold(self.invocations, device_index, limit)

    def list_command_responses(self, originating_event_id: Optional[str] = None,
                               limit: int = 1000) -> list[DeviceCommandResponse]:
        items = self.responses
        if originating_event_id is not None:
            items = [r for r in items if r.originating_event_id == originating_event_id]
        return items[-limit:]

    def list_state_changes(self, device_index: Optional[int] = None,
                           limit: int = 1000) -> list[DeviceStateChange]:
        return self._filter_cold(self.state_changes, device_index, limit)


class InMemoryAssetManagement(_TableSnapshotMixin):
    _TABLES = ("asset_types", "assets")

    def __init__(self) -> None:
        self.asset_types = _EntityTable(self._mutated, "asset_types")
        self.assets = _EntityTable(self._mutated, "assets")

    def create_asset_type(self, at: AssetType) -> AssetType:
        return self.asset_types.put(at)

    def get_asset_type(self, id: str) -> Optional[AssetType]:
        return self.asset_types.get(id)

    def get_asset_type_by_token(self, token: str) -> Optional[AssetType]:
        return self.asset_types.get_by_token(token)

    def list_asset_types(self, page: int = 1, page_size: int = 100) -> list[AssetType]:
        return _page(self.asset_types.values(), page, page_size)

    def create_asset(self, a: Asset) -> Asset:
        return self.assets.put(a)

    def get_asset(self, id: str) -> Optional[Asset]:
        return self.assets.get(id)

    def get_asset_by_token(self, token: str) -> Optional[Asset]:
        return self.assets.get_by_token(token)

    def update_asset(self, a: Asset) -> Asset:
        a = dataclasses.replace(a, updated_date=time.time())
        return self.assets.put(a)

    def delete_asset(self, id: str) -> Optional[Asset]:
        return self.assets.delete(id)

    def list_assets(self, asset_type_id: Optional[str] = None,
                    page: int = 1, page_size: int = 100) -> list[Asset]:
        items = self.assets.values()
        if asset_type_id is not None:
            items = [a for a in items if a.asset_type_id == asset_type_id]
        return _page(items, page, page_size)


class InMemoryUserManagement(_TableSnapshotMixin):
    """Password hashing: salted PBKDF2 (stdlib; the reference uses Spring
    Security encoders — capability, not algorithm, is the parity bar).
    Snapshots carry the salted hashes inside the User entities — never
    plaintext."""

    _TABLES = ("users",)

    def __init__(self) -> None:
        self.users = _EntityTable(self._mutated, "users")

    @staticmethod
    def _hash(password: str, salt: bytes) -> str:
        import hashlib
        dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 50_000)
        return salt.hex() + "$" + dk.hex()

    def create_user(self, user: User, password: str) -> User:
        import os as _os
        salt = _os.urandom(16)
        user = dataclasses.replace(user, hashed_password=self._hash(password, salt),
                                   token=user.token or user.username)
        return self.users.put(user)

    def get_user_by_username(self, username: str) -> Optional[User]:
        for u in self.users.values():
            if u.username == username:
                return u
        return None

    def authenticate(self, username: str, password: str) -> Optional[User]:
        u = self.get_user_by_username(username)
        if u is None or "$" not in u.hashed_password:
            return None
        salt_hex, _ = u.hashed_password.split("$", 1)
        if self._hash(password, bytes.fromhex(salt_hex)) == u.hashed_password:
            return u
        return None

    def update_user(self, user: User) -> User:
        user = dataclasses.replace(user, updated_date=time.time())
        return self.users.put(user)

    def delete_user(self, username: str) -> Optional[User]:
        u = self.get_user_by_username(username)
        return self.users.delete(u.id) if u else None

    def list_users(self) -> list[User]:
        return self.users.values()


class InMemoryTenantManagement(_TableSnapshotMixin):
    _TABLES = ("tenants",)

    def __init__(self) -> None:
        self.tenants = _EntityTable(self._mutated, "tenants")

    def create_tenant(self, tenant: Tenant) -> Tenant:
        return self.tenants.put(tenant)

    def get_tenant(self, id: str) -> Optional[Tenant]:
        return self.tenants.get(id)

    def get_tenant_by_token(self, token: str) -> Optional[Tenant]:
        return self.tenants.get_by_token(token)

    def update_tenant(self, tenant: Tenant) -> Tenant:
        tenant = dataclasses.replace(tenant, updated_date=time.time())
        return self.tenants.put(tenant)

    def delete_tenant(self, id: str) -> Optional[Tenant]:
        return self.tenants.delete(id)

    def list_tenants(self) -> list[Tenant]:
        return self.tenants.values()


class InMemoryScheduleManagement:
    def __init__(self) -> None:
        self.schedules = _EntityTable()
        self.jobs = _EntityTable()

    def create_schedule(self, s: Schedule) -> Schedule:
        return self.schedules.put(s)

    def get_schedule(self, id: str) -> Optional[Schedule]:
        return self.schedules.get(id)

    def get_schedule_by_token(self, token: str) -> Optional[Schedule]:
        return self.schedules.get_by_token(token)

    def delete_schedule(self, id: str) -> Optional[Schedule]:
        return self.schedules.delete(id)

    def list_schedules(self) -> list[Schedule]:
        return self.schedules.values()

    def create_scheduled_job(self, j: ScheduledJob) -> ScheduledJob:
        return self.jobs.put(j)

    def get_scheduled_job(self, id: str) -> Optional[ScheduledJob]:
        return self.jobs.get(id)

    def delete_scheduled_job(self, id: str) -> Optional[ScheduledJob]:
        return self.jobs.delete(id)

    def list_scheduled_jobs(self) -> list[ScheduledJob]:
        return self.jobs.values()


class InMemoryBatchManagement:
    def __init__(self) -> None:
        self.operations = _EntityTable()
        self.elements: dict[str, list[BatchElement]] = {}

    def create_batch_operation(self, op: BatchOperation) -> BatchOperation:
        return self.operations.put(op)

    def get_batch_operation(self, id: str) -> Optional[BatchOperation]:
        return self.operations.get(id)

    def update_batch_operation(self, op: BatchOperation) -> BatchOperation:
        op = dataclasses.replace(op, updated_date=time.time())
        return self.operations.put(op)

    def list_batch_operations(self, page: int = 1, page_size: int = 100) -> list[BatchOperation]:
        return _page(self.operations.values(), page, page_size)

    def create_batch_elements(self, elements: Iterable[BatchElement]) -> list[BatchElement]:
        out = []
        for el in elements:
            self.elements.setdefault(el.batch_operation_id, []).append(el)
            out.append(el)
        return out

    def update_batch_element(self, el: BatchElement) -> BatchElement:
        lst = self.elements.get(el.batch_operation_id, [])
        for i, existing in enumerate(lst):
            if existing.id == el.id:
                lst[i] = el
                break
        return el

    def list_batch_elements(self, batch_operation_id: str,
                            status: Optional[str] = None) -> list[BatchElement]:
        items = list(self.elements.get(batch_operation_id, []))
        if status is not None:
            items = [e for e in items if e.processing_status.value == status]
        return items
