"""device-registration service (reference: service-device-registration,
[SURVEY.md §2.2]): auto-register unknown devices from registration
payloads, applying per-tenant default device-type/area policies.

Consumes the unregistered-device topic that inbound-processing splits off
[SURVEY.md §3.2]. Two record shapes arrive:

- `RegistrationBatch` (token-addressed, from the JSON decoder or an
  explicit registration payload): devices are created with an assignment
  if `allow_unknown_devices` is on; a device-type token in the request
  overrides the tenant default.
- `{"device_indices": ...}` (SWB1 events whose dense index is unknown):
  indices are server-assigned, so these cannot be auto-registered — they
  are counted and dropped (a hostile or misconfigured gateway, not a new
  device).

Tenant config section `device-registration`:
  allow_unknown_devices: true
  default_device_type: "<token>"     (required to auto-register)
  default_area: "<token>" | null
"""

from __future__ import annotations

import asyncio
import logging

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.batch import (
    ACK_ALREADY,
    ACK_NEW,
    ACK_REJECTED,
    RegistrationAck,
    RegistrationBatch,
)
from sitewhere_tpu_torch.domain.model import Device, DeviceAssignment, DeviceType
from sitewhere_tpu_torch.kernel.bus import FencedError, TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine

logger = logging.getLogger(__name__)


class DeviceRegistrationEngine(TenantEngine):
    def __init__(self, service: "DeviceRegistrationService", tenant: TenantConfig):
        super().__init__(service, tenant)
        cfg = tenant.section("device-registration", {})
        self.allow_unknown = cfg.get("allow_unknown_devices", True)
        self.default_device_type = cfg.get("default_device_type")
        self.default_area = cfg.get("default_area")
        self.manager = RegistrationManager(self)
        self.add_child(self.manager)


class RegistrationManager(BackgroundTaskComponent):
    """(reference: RegistrationManager)"""

    def __init__(self, engine: DeviceRegistrationEngine):
        super().__init__("registration-manager")
        self.engine = engine

    async def _run(self) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        dm = await runtime.wait_for_engine("device-management", tenant_id)
        registered = runtime.metrics.counter("registration.devices_registered")
        rejected = runtime.metrics.counter("registration.requests_rejected")
        unknown_idx = runtime.metrics.counter("registration.unknown_indices")
        consumer = runtime.bus.subscribe(
            engine.tenant_topic(TopicNaming.UNREGISTERED_DEVICES),
            group=f"{tenant_id}.device-registration")
        # clean-handoff commit-through (same contract as the inbound
        # processor): a cancellation mid-batch must not lose a handled
        # record's commit — a redelivery would re-run registration and
        # re-send acks down device command routes. The finally commits
        # the handled prefix exactly.
        handled: dict[tuple[str, int], int] = {}
        try:
            while True:
                for record in await consumer.poll(max_records=64, timeout=0.5):
                    # poison quarantine: a registration whose policy
                    # lookup/creation raises goes to the tenant DLQ —
                    # one malformed request must not stop the tenant's
                    # auto-registration path (found by swx lint DLQ01)
                    try:
                        value = record.value
                        if isinstance(value, RegistrationBatch):
                            ack = self._register(dm, value)
                            n = sum(1 for s in ack.status if s == ACK_NEW)
                            registered.inc(n)
                            n_rej = sum(
                                1 for s in ack.status if s == ACK_REJECTED)
                            if n_rej:
                                rejected.inc(n_rej)
                            # compact agent protocol round trip: the binary
                            # ack rides the device's command route (reference:
                            # RegistrationAck down the MQTT command topic)
                            await self._send_acks(dm, ack)
                        elif isinstance(value, dict) \
                                and "device_indices" in value:
                            unknown_idx.inc(len(value["device_indices"]))
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        await engine.dead_letter(record, exc, self.path)
                    # slotted-attribute reads cannot raise — bookkeeping
                    handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                try:
                    consumer.commit(fence=engine.fence_token())
                except FencedError:
                    # ownership moved (epoch fencing): offsets stay for
                    # the new owner; the fleet worker stops these engines
                    engine.fence_lost()
        finally:
            try:
                if handled:
                    # commit the handled prefix (see above); fenced or
                    # evicted refusals leave the offsets to the owner
                    consumer.commit(dict(handled),
                                    fence=engine.fence_token())
            except (FencedError, RuntimeError):
                pass
            consumer.close()

    def _register(self, dm, batch: RegistrationBatch) -> RegistrationAck:
        engine = self.engine
        tokens = list(batch.device_tokens)

        def all_status(st: int) -> RegistrationAck:
            return RegistrationAck(tokens, [st] * len(tokens),
                                   [-1] * len(tokens))

        if not engine.allow_unknown:
            return all_status(ACK_REJECTED)
        dt_token = batch.device_type_token or engine.default_device_type
        if not dt_token:
            logger.warning("registration: no device type for %s", tokens)
            return all_status(ACK_REJECTED)
        dt = dm.get_device_type_by_token(dt_token)
        if dt is None:
            # first sight of the default type: create it (dataset-template
            # analog — a fresh tenant needs no manual pre-seeding)
            dt = dm.create_device_type(DeviceType(token=dt_token, name=dt_token))
        area_id = None
        if batch.area_token or engine.default_area:
            area = dm.get_area_by_token(batch.area_token or engine.default_area)
            area_id = area.id if area else None
        status, index = [], []
        for token in tokens:
            existing = dm.get_device_by_token(token)
            if existing is not None:
                # already registered (at-least-once redelivery): ack with
                # the existing index so the device still learns its slot
                status.append(ACK_ALREADY)
                index.append(int(existing.index))
                continue
            device = dm.create_device(Device(
                token=token, device_type_id=dt.id,
                metadata=dict(batch.metadata)))
            dm.create_device_assignment(DeviceAssignment(
                device_id=device.id, area_id=area_id, token=f"{token}-auto"))
            status.append(ACK_NEW)
            index.append(int(device.index))
        return RegistrationAck(tokens, status, index)

    async def _send_acks(self, dm, ack: RegistrationAck) -> None:
        """Per-device binary acks via command-delivery's routed provider.
        Best-effort: no command-delivery service (or no live downlink for
        the device) just means the device polls its index instead."""
        runtime = self.engine.runtime
        svc = runtime.services.get("command-delivery")
        if svc is None:
            return
        delivery = svc.engines.get(self.engine.tenant_id)
        if delivery is None:
            return
        for i, token in enumerate(ack.device_tokens):
            device = dm.get_device_by_token(token)
            if device is None:
                continue
            one = RegistrationAck([token], [ack.status[i]],
                                  [ack.device_index[i]])
            try:
                await delivery.deliver_raw(device, one.encode())
            except Exception:  # noqa: BLE001 - ack delivery is best-effort
                logger.exception("registration ack delivery failed for %s",
                                 token)


class DeviceRegistrationService(Service):
    identifier = "device-registration"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> DeviceRegistrationEngine:
        return DeviceRegistrationEngine(self, tenant)
