"""Device event family (per-event objects for the API/persistence surface).

Capability parity with SiteWhere's event model [SURVEY.md §2.1]:
measurement, location, alert, command invocation, command response, and
state change — all carrying assignment context, event/received timestamps,
and metadata.

These objects are the *query/REST* representation. On the ingest hot path
events travel as columnar batches (`domain.batch`); converters here
materialize per-event objects only when an API consumer asks.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


class DeviceEventType(enum.Enum):
    MEASUREMENT = "measurement"
    LOCATION = "location"
    ALERT = "alert"
    COMMAND_INVOCATION = "command_invocation"
    COMMAND_RESPONSE = "command_response"
    STATE_CHANGE = "state_change"


class AlertLevel(enum.Enum):
    INFO = 0
    WARNING = 1
    ERROR = 2
    CRITICAL = 3


@dataclass(frozen=True, slots=True)
class DeviceEvent:
    """Base event (reference: IDeviceEvent)."""

    id: str = field(default_factory=lambda: uuid.uuid4().hex)
    device_id: str = ""
    assignment_id: str = ""
    customer_id: Optional[str] = None
    area_id: Optional[str] = None
    asset_id: Optional[str] = None
    event_date: float = field(default_factory=time.time)
    received_date: float = field(default_factory=time.time)
    metadata: dict = field(default_factory=dict, hash=False, compare=False)

    event_type: DeviceEventType = DeviceEventType.MEASUREMENT


@dataclass(frozen=True, slots=True)
class DeviceMeasurement(DeviceEvent):
    """Scalar measurement (reference: IDeviceMeasurement)."""

    name: str = "value"
    value: float = 0.0
    event_type: DeviceEventType = DeviceEventType.MEASUREMENT


@dataclass(frozen=True, slots=True)
class DeviceLocation(DeviceEvent):
    """(reference: IDeviceLocation)."""

    latitude: float = 0.0
    longitude: float = 0.0
    elevation: float = 0.0
    event_type: DeviceEventType = DeviceEventType.LOCATION


@dataclass(frozen=True, slots=True)
class DeviceAlert(DeviceEvent):
    """(reference: IDeviceAlert). `source` distinguishes device-originated
    alerts from system-generated ones (the model plane emits source='model')."""

    source: str = "device"
    level: AlertLevel = AlertLevel.INFO
    type: str = ""
    message: str = ""
    event_type: DeviceEventType = DeviceEventType.ALERT


@dataclass(frozen=True, slots=True)
class DeviceCommandInvocation(DeviceEvent):
    """(reference: IDeviceCommandInvocation)."""

    initiator: str = "rest"          # rest | script | batch | schedule
    initiator_id: str = ""
    target: str = "assignment"
    command_id: str = ""
    parameter_values: dict = field(default_factory=dict, hash=False, compare=False)
    event_type: DeviceEventType = DeviceEventType.COMMAND_INVOCATION


@dataclass(frozen=True, slots=True)
class DeviceCommandResponse(DeviceEvent):
    """(reference: IDeviceCommandResponse)."""

    originating_event_id: str = ""
    response_event_id: Optional[str] = None
    response: str = ""
    event_type: DeviceEventType = DeviceEventType.COMMAND_RESPONSE


@dataclass(frozen=True, slots=True)
class DeviceStateChange(DeviceEvent):
    """(reference: IDeviceStateChange)."""

    attribute: str = ""
    state_change_type: str = ""
    previous_state: str = ""
    new_state: str = ""
    event_type: DeviceEventType = DeviceEventType.STATE_CHANGE


def event_to_dict(event: DeviceEvent) -> dict:
    import dataclasses as _dc

    out: dict[str, Any] = {}
    for f in _dc.fields(event):
        v = getattr(event, f.name)
        if isinstance(v, enum.Enum):
            v = v.value if not isinstance(v.value, int) else v.name.lower()
        out[f.name] = v
    return out
