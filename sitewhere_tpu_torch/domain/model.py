"""Device/asset/tenant object model.

Capability parity with SiteWhere's core POJOs [SURVEY.md §2.1 "Object
model + SPIs"]: `Device`, `DeviceType`, `DeviceCommand`, `DeviceStatus`,
`DeviceAssignment`, `DeviceGroup`, `Customer`, `Area`, `Zone`, `Asset`,
`Tenant`, `User`. Frozen dataclasses; every entity has a stable `token`
(external id) and server-assigned `id`.

TPU-first addition: each `Device` carries a dense per-tenant integer
`index` assigned at creation. All hot-path structures (columnar batches,
state tables, model inputs) are keyed by this index, so device lookup on
the ingest path is an O(1) array op instead of the reference's per-event
gRPC round-trip to device-management [SURVEY.md §3.2 hot-loop note].
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


def new_id() -> str:
    return uuid.uuid4().hex


@dataclass(frozen=True, slots=True)
class PersistentEntity:
    """Common base: server id, external token, audit dates, metadata."""

    id: str = field(default_factory=new_id)
    token: str = ""
    created_date: float = field(default_factory=time.time)
    updated_date: float = field(default_factory=time.time)
    metadata: dict = field(default_factory=dict, hash=False, compare=False)


@dataclass(frozen=True, slots=True)
class DeviceType(PersistentEntity):
    """A kind of device (reference: IDeviceType)."""

    name: str = ""
    description: str = ""
    image_url: str = ""
    container_policy: str = "standalone"  # standalone | composite
    # measurement channels this type emits, in channel order; the channel
    # index is the `mtype` id used in columnar batches
    channels: tuple[str, ...] = ("value",)


@dataclass(frozen=True, slots=True)
class DeviceCommand(PersistentEntity):
    """Command a device type understands (reference: IDeviceCommand)."""

    device_type_id: str = ""
    name: str = ""
    namespace: str = "http://swx/default"
    description: str = ""
    # (name, type, required) triples; types: string|double|int64|bool
    parameters: tuple[tuple[str, str, bool], ...] = ()


@dataclass(frozen=True, slots=True)
class DeviceStatus(PersistentEntity):
    """Named status a device of a type can be in (reference: IDeviceStatus)."""

    device_type_id: str = ""
    code: str = ""
    name: str = ""
    background_color: str = "#ffffff"
    foreground_color: str = "#000000"
    icon: str = ""


@dataclass(frozen=True, slots=True)
class Device(PersistentEntity):
    """A physical device (reference: IDevice).

    `index` is the dense per-tenant slot (TPU-first; see module docstring).
    """

    device_type_id: str = ""
    index: int = -1
    comments: str = ""
    status: str = "active"
    parent_device_id: Optional[str] = None  # composite containment


class DeviceAssignmentStatus(enum.Enum):
    ACTIVE = "active"
    MISSING = "missing"
    RELEASED = "released"


@dataclass(frozen=True, slots=True)
class DeviceAssignment(PersistentEntity):
    """Association of a device with customer/area/asset (reference:
    IDeviceAssignment). Events are always recorded against an assignment."""

    device_id: str = ""
    device_type_id: str = ""
    customer_id: Optional[str] = None
    area_id: Optional[str] = None
    asset_id: Optional[str] = None
    status: DeviceAssignmentStatus = DeviceAssignmentStatus.ACTIVE
    active_date: float = field(default_factory=time.time)
    released_date: Optional[float] = None


@dataclass(frozen=True, slots=True)
class DeviceGroup(PersistentEntity):
    """Named group of devices with roles (reference: IDeviceGroup)."""

    name: str = ""
    description: str = ""
    roles: tuple[str, ...] = ()


@dataclass(frozen=True, slots=True)
class DeviceGroupElement(PersistentEntity):
    group_id: str = ""
    device_id: Optional[str] = None
    nested_group_id: Optional[str] = None
    roles: tuple[str, ...] = ()


@dataclass(frozen=True, slots=True)
class Customer(PersistentEntity):
    """(reference: ICustomer; customer hierarchies via parent)."""

    name: str = ""
    description: str = ""
    customer_type: str = "default"
    parent_customer_id: Optional[str] = None


@dataclass(frozen=True, slots=True)
class Area(PersistentEntity):
    """Geographic area, hierarchical (reference: IArea)."""

    name: str = ""
    description: str = ""
    area_type: str = "default"
    parent_area_id: Optional[str] = None
    # boundary polygon [(lat, lon), ...]
    bounds: tuple[tuple[float, float], ...] = ()


@dataclass(frozen=True, slots=True)
class Zone(PersistentEntity):
    """Polygon zone within an area (reference: IZone)."""

    area_id: str = ""
    name: str = ""
    bounds: tuple[tuple[float, float], ...] = ()
    border_color: str = "#ff0000"
    fill_color: str = "#ff0000"
    opacity: float = 0.3


@dataclass(frozen=True, slots=True)
class AssetType(PersistentEntity):
    """(reference: IAssetType; person/hardware/location categories)."""

    name: str = ""
    description: str = ""
    asset_category: str = "hardware"  # person | device | hardware | location


@dataclass(frozen=True, slots=True)
class Asset(PersistentEntity):
    """(reference: IAsset)."""

    asset_type_id: str = ""
    name: str = ""
    image_url: str = ""


@dataclass(frozen=True, slots=True)
class Tenant(PersistentEntity):
    """(reference: ITenant)."""

    name: str = ""
    auth_token: str = ""
    logo_url: str = ""
    authorized_user_ids: tuple[str, ...] = ()
    tenant_template_id: str = "empty"
    dataset_template_id: str = "empty"


@dataclass(frozen=True, slots=True)
class User(PersistentEntity):
    """(reference: IUser; granted authorities drive REST authz)."""

    username: str = ""
    hashed_password: str = ""
    first_name: str = ""
    last_name: str = ""
    status: str = "active"
    authorities: tuple[str, ...] = ()


@dataclass(frozen=True, slots=True)
class ScheduledJob(PersistentEntity):
    """(reference: IScheduledJob in schedule-management)."""

    schedule_id: str = ""
    job_type: str = "command-invocation"  # or batch-command-invocation
    job_state: str = "active"
    configuration: dict = field(default_factory=dict, hash=False, compare=False)


@dataclass(frozen=True, slots=True)
class Schedule(PersistentEntity):
    """(reference: ISchedule; simple + cron trigger types)."""

    name: str = ""
    trigger_type: str = "simple"  # simple | cron
    # simple: {"repeat_interval_s": N, "repeat_count": -1}; cron: {"expression": "..."}
    trigger_configuration: dict = field(default_factory=dict, hash=False, compare=False)
    start_date: Optional[float] = None
    end_date: Optional[float] = None


class BatchOperationStatus(enum.Enum):
    UNPROCESSED = "unprocessed"
    INITIALIZING = "initializing"
    PROCESSING = "processing"
    FINISHED_SUCCESSFULLY = "finished"
    FINISHED_WITH_ERRORS = "finished_with_errors"


class BatchElementStatus(enum.Enum):
    UNPROCESSED = "unprocessed"
    PROCESSING = "processing"
    FAILED = "failed"
    SUCCEEDED = "succeeded"


@dataclass(frozen=True, slots=True)
class BatchOperation(PersistentEntity):
    """(reference: IBatchOperation in batch-operations)."""

    operation_type: str = "command-invocation"  # or train-model, score-backfill
    parameters: dict = field(default_factory=dict, hash=False, compare=False)
    processing_status: BatchOperationStatus = BatchOperationStatus.UNPROCESSED
    processing_started_date: Optional[float] = None
    processing_ended_date: Optional[float] = None


@dataclass(frozen=True, slots=True)
class BatchElement(PersistentEntity):
    """One unit of a batch operation (reference: IBatchElement)."""

    batch_operation_id: str = ""
    device_id: str = ""
    processing_status: BatchElementStatus = BatchElementStatus.UNPROCESSED
    processed_date: Optional[float] = None
    result: dict = field(default_factory=dict, hash=False, compare=False)


def entity_to_dict(entity: Any) -> dict:
    """JSON-safe dict for REST marshaling (enum → value)."""
    import dataclasses as _dc

    out = {}
    for f in _dc.fields(entity):
        v = getattr(entity, f.name)
        if isinstance(v, enum.Enum):
            v = v.value
        elif isinstance(v, tuple):
            v = list(v)
        out[f.name] = v
    return out
