"""The services the port hosts: the six of the scored pipeline
(device-management → event-sources → inbound-processing →
event-management → device-state, and rule-processing, the one that
scores on the card). The JAX package's other eight services, and REST
over them, are ROADMAP A.1.4."""

from sitewhere_tpu_torch.services.device_management import DeviceManagementService
from sitewhere_tpu_torch.services.device_state import DeviceStateService
from sitewhere_tpu_torch.services.event_management import EventManagementService
from sitewhere_tpu_torch.services.event_sources import EventSourcesService
from sitewhere_tpu_torch.services.inbound_processing import InboundProcessingService
from sitewhere_tpu_torch.services.rule_processing import RuleProcessingService

__all__ = [
    "DeviceManagementService",
    "DeviceStateService",
    "EventManagementService",
    "EventSourcesService",
    "InboundProcessingService",
    "RuleProcessingService",
]
