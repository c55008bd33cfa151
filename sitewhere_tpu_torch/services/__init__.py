"""The services the port hosts: all fourteen of the JAX package's
(reference layer L4). Six make the scored pipeline (device-management
→ event-sources → inbound-processing → event-management → device-state,
and rule-processing, which scores on the card); the other eight are
asset-management, device-registration, command-delivery,
outbound-connectors, batch-operations (training and the GNN sweep, on
the runtime's device), schedule-management, label-generation and
instance-management, which hosts the REST facade (`rest/api.py`).

All services share the in-proc runtime; cross-service traffic rides the
topic bus (data plane) or `runtime.api()` (control/query plane).
"""

from sitewhere_tpu_torch.services.device_management import DeviceManagementService
from sitewhere_tpu_torch.services.asset_management import AssetManagementService
from sitewhere_tpu_torch.services.event_management import EventManagementService
from sitewhere_tpu_torch.services.event_sources import EventSourcesService
from sitewhere_tpu_torch.services.inbound_processing import InboundProcessingService
from sitewhere_tpu_torch.services.device_state import DeviceStateService
from sitewhere_tpu_torch.services.rule_processing import RuleProcessingService
from sitewhere_tpu_torch.services.device_registration import DeviceRegistrationService
from sitewhere_tpu_torch.services.command_delivery import CommandDeliveryService
from sitewhere_tpu_torch.services.outbound_connectors import OutboundConnectorsService
from sitewhere_tpu_torch.services.batch_operations import BatchOperationsService
from sitewhere_tpu_torch.services.schedule_management import ScheduleManagementService
from sitewhere_tpu_torch.services.label_generation import LabelGenerationService
from sitewhere_tpu_torch.services.instance_management import InstanceManagementService

ALL_SERVICES = [
    "InstanceManagementService",
    "DeviceManagementService",
    "AssetManagementService",
    "EventManagementService",
    "EventSourcesService",
    "InboundProcessingService",
    "DeviceStateService",
    "RuleProcessingService",
    "DeviceRegistrationService",
    "CommandDeliveryService",
    "OutboundConnectorsService",
    "BatchOperationsService",
    "ScheduleManagementService",
    "LabelGenerationService",
]

__all__ = list(ALL_SERVICES)
