"""command-delivery service (reference: service-command-delivery,
[SURVEY.md §2.2, §3.3]): route persisted command invocations to devices —
encode (JSON / SWB1-binary) and deliver (in-proc queue, TCP push, or a
registered custom provider; the reference's MQTT/CoAP/SMS providers map
to the same `DeliveryProvider` protocol).

Flow (reference §3.3): event-management persists a DeviceCommandInvocation
and republishes it on the enriched topic; this service consumes it,
resolves the target device + command, encodes, routes, delivers, and
emits an `undelivered` record on failure.

Tenant config section `command-delivery`:
  encoder: "json" | "swb1"
  provider: "queue" | "tcp" | <registered name>
  routes: {"<device_type_token>": {"encoder": ..., "provider": ...}}
"""

from __future__ import annotations

import asyncio
import json
import logging
import struct
import time
from typing import Optional, Protocol

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.events import DeviceCommandInvocation
from sitewhere_tpu_torch.domain.model import Device, DeviceCommand
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.kernel.fastlane import produce_settled
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine

logger = logging.getLogger(__name__)


class CommandEncoder(Protocol):
    """(reference: ICommandExecutionEncoder)"""

    def encode(self, device: Device, command: Optional[DeviceCommand],
               invocation: DeviceCommandInvocation) -> bytes: ...


class JsonCommandEncoder:
    def encode(self, device, command, invocation) -> bytes:
        return json.dumps({
            "device": device.token,
            "command": command.name if command else invocation.command_id,
            "namespace": command.namespace if command else "",
            "parameters": invocation.parameter_values,
            "invocation_id": invocation.id,
            "initiator": invocation.initiator,
        }).encode()


class Swb1CommandEncoder:
    """Compact binary framing for constrained devices (the reference's
    protobuf agent-protocol encoder analog): magic 'SWC1' | u32 device
    index | u16 name len | name | u32 json-params len | params."""

    def encode(self, device, command, invocation) -> bytes:
        name = (command.name if command else invocation.command_id).encode()
        params = json.dumps(invocation.parameter_values).encode()
        return (b"SWC1" + struct.pack("<IH", device.index, len(name)) + name
                + struct.pack("<I", len(params)) + params)


class ScriptedCommandEncoder:
    """Tenant-scripted command encoder (reference analog: the Groovy
    ICommandExecutionEncoder beside the Groovy decoder/connector
    scripts): the operator uploads a python script defining

        def encode(device, command, invocation) -> bytes

    and routes device types to it with {"encoder": "script:<name>"}.
    The manager is consulted per encode, so a script upload hot-swaps
    the wire format mid-stream — a proprietary downlink framing gets
    first-class delivery without forking the platform."""

    def __init__(self, manager, name: str):
        self._manager = manager
        self._name = name

    def encode(self, device, command, invocation) -> bytes:
        out = self._manager.hook(self._name)(device, command, invocation)
        if not isinstance(out, (bytes, bytearray)):
            raise ValueError(
                f"encoder script {self._name!r} must return bytes, "
                f"got {type(out).__name__}")
        return bytes(out)


class DeliveryProvider(Protocol):
    """(reference: ICommandDeliveryProvider)"""

    async def deliver(self, device: Device, payload: bytes) -> bool: ...


class QueueDeliveryProvider:
    """In-proc delivery log/queue: the default provider, the test double,
    and the device simulator's command inbox."""

    def __init__(self) -> None:
        self.delivered: list[tuple[str, bytes, float]] = []

    async def deliver(self, device: Device, payload: bytes) -> bool:
        self.delivered.append((device.token, payload, time.time()))
        return True

    def inbox(self, device_token: str) -> list[bytes]:
        return [p for t, p, _ in self.delivered if t == device_token]


class TcpPushDeliveryProvider:
    """Push commands to a per-device TCP endpoint recorded in device
    metadata (`push_host`/`push_port`) — length-prefixed frames."""

    async def deliver(self, device: Device, payload: bytes) -> bool:
        import asyncio

        host = device.metadata.get("push_host")
        port = device.metadata.get("push_port")
        if not host or not port:
            return False
        try:
            _, writer = await asyncio.open_connection(host, int(port))
            writer.write(len(payload).to_bytes(4, "little") + payload)
            await writer.drain()
            writer.close()
            return True
        except OSError as exc:
            logger.warning("tcp delivery to %s failed: %s", device.token, exc)
            return False


class MqttDeliveryProvider:
    """Deliver commands to devices subscribed over the MQTT ingest
    endpoint (reference: MqttCommandDeliveryProvider publishing to
    per-device command topics). The device subscribes to
    `swx/commands/<device-token>` on the same connection it publishes
    telemetry on; delivery is a QoS0 PUBLISH down that session."""

    def __init__(self, runtime, tenant_id: str,
                 receiver_name: str = "mqtt",
                 topic_prefix: str = "swx/commands/"):
        self.runtime = runtime
        self.tenant_id = tenant_id
        self.receiver_name = receiver_name
        self.topic_prefix = topic_prefix

    async def deliver(self, device: Device, payload: bytes) -> bool:
        try:
            engine = self.runtime.api("event-sources").engine(self.tenant_id)
            receiver = engine.receiver(self.receiver_name)
        except KeyError:
            return False
        listener = getattr(receiver, "listener", None)
        if listener is None:
            return False
        n = await listener.publish_to_subscribers(
            f"{self.topic_prefix}{device.token}", payload)
        return n > 0


class WebSocketDeliveryProvider:
    """Deliver commands down a device's live WebSocket session (the
    device connected to ws://.../ws/<device-token>)."""

    def __init__(self, runtime, tenant_id: str,
                 receiver_name: str = "websocket"):
        self.runtime = runtime
        self.tenant_id = tenant_id
        self.receiver_name = receiver_name

    async def deliver(self, device: Device, payload: bytes) -> bool:
        try:
            engine = self.runtime.api("event-sources").engine(self.tenant_id)
            receiver = engine.receiver(self.receiver_name)
        except KeyError:
            return False
        listener = getattr(receiver, "listener", None)
        if listener is None or not hasattr(listener, "send"):
            return False
        return await listener.send(device.token, payload)


class HttpDeliveryProvider:
    """Push the encoded command to an external HTTP gateway (reference
    analog: the Twilio-SMS delivery provider — upstream integrates
    carrier/cloud messaging by POSTing to a service API; same contract
    here, testable against any local HTTP server). `url_template` may
    contain `{device}` (device token) and `{type}` (device type id);
    the body is the encoder's output verbatim
    (application/octet-stream). 2xx = delivered; failures retry with
    backoff and then report undelivered (command-delivery's normal
    undelivered accounting applies)."""

    def __init__(self, url_template: str, retries: int = 3,
                 backoff_s: float = 0.2, timeout_s: float = 10.0):
        from sitewhere_tpu_torch.utils.http import parse_http_url

        # validate scheme/shape at config time with a sample substitution
        parse_http_url(url_template.format(device="x", type="t"),
                       "http delivery provider")
        self.url_template = url_template
        self.retries = max(1, retries)
        self.backoff_s = backoff_s
        self.timeout_s = timeout_s
        self.delivered = 0
        self.failed = 0

    async def deliver(self, device: Device, payload: bytes) -> bool:
        from sitewhere_tpu_torch.utils.http import (
            http_post_retrying,
            parse_http_url,
        )

        url = self.url_template.format(device=device.token,
                                       type=device.device_type_id)
        host, port, path = parse_http_url(url)
        ok, _last = await http_post_retrying(
            host, port, path, payload,
            content_type="application/octet-stream",
            retries=self.retries, backoff_s=self.backoff_s,
            timeout_s=self.timeout_s)
        if ok:
            self.delivered += 1
        else:
            self.failed += 1
        return ok


class CoapDeliveryProvider:
    """Deliver commands to a device's own CoAP server (reference:
    the CoAP command-delivery provider beside MQTT/SMS [SURVEY.md §2.2
    command-delivery]): a confirmable POST to
    coap://<coap_host>:<coap_port>/<path> recorded in device metadata,
    with RFC 7252 retransmission; delivery succeeds on any 2.xx."""

    def __init__(self, path: str = "commands", ack_timeout: float = 2.0,
                 max_retransmit: int = 2):
        self.path = path
        self.ack_timeout = ack_timeout
        self.max_retransmit = max_retransmit

    async def deliver(self, device: Device, payload: bytes) -> bool:
        from sitewhere_tpu_torch.services.coap import coap_post

        host = device.metadata.get("coap_host")
        port = device.metadata.get("coap_port")
        if not host or not port:
            return False
        try:
            code = await coap_post(
                host, int(port), self.path, payload,
                ack_timeout=self.ack_timeout,
                max_retransmit=self.max_retransmit)
        except (TimeoutError, ConnectionResetError, OSError) as exc:
            logger.warning("coap delivery to %s failed: %s",
                           device.token, exc)
            return False
        return 0x40 <= code < 0x60  # 2.xx


class CommandDeliveryEngine(TenantEngine):
    def __init__(self, service: "CommandDeliveryService", tenant: TenantConfig):
        super().__init__(service, tenant)
        cfg = tenant.section("command-delivery", {})
        self.encoders: dict[str, CommandEncoder] = {
            "json": JsonCommandEncoder(), "swb1": Swb1CommandEncoder()}
        self.providers: dict[str, DeliveryProvider] = {
            "queue": QueueDeliveryProvider(), "tcp": TcpPushDeliveryProvider(),
            "mqtt": MqttDeliveryProvider(
                self.runtime, self.tenant_id,
                receiver_name=cfg.get("mqtt_receiver", "mqtt"),
                topic_prefix=cfg.get("mqtt_topic_prefix", "swx/commands/")),
            "websocket": WebSocketDeliveryProvider(
                self.runtime, self.tenant_id,
                receiver_name=cfg.get("websocket_receiver", "websocket")),
            "coap": CoapDeliveryProvider(
                path=cfg.get("coap_path", "commands"),
                ack_timeout=cfg.get("coap_ack_timeout", 2.0),
                max_retransmit=cfg.get("coap_max_retransmit", 2))}
        # external HTTP gateway push (Twilio-SMS analog): only built
        # when configured — a URL template is required
        if cfg.get("http_url"):
            self.providers["http"] = HttpDeliveryProvider(
                cfg["http_url"],
                retries=cfg.get("http_retries", 3),
                backoff_s=cfg.get("http_backoff_s", 0.2),
                timeout_s=cfg.get("http_timeout_s", 10.0))
        self.default_encoder = cfg.get("encoder", "json")
        self.default_provider = cfg.get("provider", "queue")
        self.routes: dict[str, dict] = cfg.get("routes", {})
        # encoder scripts (reference: Groovy command encoder): routed as
        # "script:<name>", hot-reloadable per encode
        from sitewhere_tpu_torch.kernel.scripting import ScriptManager

        self.encoder_scripts = ScriptManager(
            self.tenant_id, entrypoint="encode", require_async=False)
        for name, source in cfg.get("scripts", {}).items():
            self.encoder_scripts.put(name, source)
        self.manager = CommandDeliveryManager(self)
        self.add_child(self.manager)

    def put_encoder_script(self, name: str, source: str):
        """Upload/hot-reload an encoder script (routes using
        `script:<name>` pick the new version up on their next encode)."""
        return self.encoder_scripts.put(name, source)

    def delete_encoder_script(self, name: str):
        """Delete an encoder script — refused while a route (or the
        tenant default) still references it."""
        ref = f"script:{name}"
        users = [t for t, r in self.routes.items()
                 if r.get("encoder") == ref]
        if self.default_encoder == ref:
            users.append("<default>")
        if users:
            raise ValueError(
                f"encoder script {name!r} is routed by {users}; "
                "re-route first")
        return self.encoder_scripts.delete(name)

    def _resolve_encoder(self, name: str) -> CommandEncoder:
        if name.startswith("script:"):
            sname = name[len("script:"):]
            if self.encoder_scripts.get(sname) is None:
                raise KeyError(f"unknown encoder script {sname!r}")
            return ScriptedCommandEncoder(self.encoder_scripts, sname)
        return self.encoders[name]

    def register_provider(self, name: str, provider: DeliveryProvider) -> None:
        """Extension point for MQTT/CoAP/SMS-style providers."""
        self.providers[name] = provider

    def register_encoder(self, name: str, encoder: CommandEncoder) -> None:
        self.encoders[name] = encoder

    def route(self, device_type_token: str) -> tuple[CommandEncoder, DeliveryProvider]:
        """(reference: ICommandRouter) resolve encoder+provider for a type."""
        r = self.routes.get(device_type_token, {})
        enc = self._resolve_encoder(r.get("encoder", self.default_encoder))
        prov = self.providers[r.get("provider", self.default_provider)]
        return enc, prov

    async def deliver_raw(self, device, payload: bytes) -> bool:
        """Deliver a pre-encoded system payload (registration acks,
        binary agent messages) down the device's routed provider —
        bypasses the command encoder, keeps the transport routing."""
        dm = self.runtime.api("device-management").management(self.tenant_id)
        dtype = dm.get_device_type(device.device_type_id)
        try:
            _, provider = self.route(dtype.token if dtype else "")
            return await provider.deliver(device, payload)
        except Exception:  # noqa: BLE001 - delivery errors are data
            logger.exception("raw delivery failed for %s", device.token)
            return False


class CommandDeliveryManager(BackgroundTaskComponent):
    def __init__(self, engine: CommandDeliveryEngine):
        super().__init__("command-delivery-manager")
        self.engine = engine

    async def _run(self) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        dm = await runtime.wait_for_engine("device-management", tenant_id)
        delivered = runtime.metrics.counter("command_delivery.delivered")
        failed = runtime.metrics.counter("command_delivery.failed")
        undelivered_topic = engine.tenant_topic(TopicNaming.UNDELIVERED_COMMANDS)
        consumer = runtime.bus.subscribe(
            engine.tenant_topic(TopicNaming.OUTBOUND_ENRICHED),
            group=f"{tenant_id}.command-delivery")
        # clean-handoff commit-through (same contract as the inbound
        # processor): a cancellation mid-batch must not let a handled
        # record's commit be lost — a redelivery would push the same
        # commands to devices twice. The finally commits the handled
        # prefix exactly.
        handled: dict[tuple[str, int], int] = {}
        try:
            while True:
                for record in await consumer.poll(max_records=64, timeout=0.5):
                    # poison quarantine: per-delivery failures already
                    # route to the undelivered topic; anything escaping
                    # that (a malformed invocation list, a broken
                    # undelivered produce) quarantines the record so
                    # command routing keeps draining
                    try:
                        value = record.value
                        if isinstance(value, list):
                            for ev in value:
                                if not isinstance(
                                        ev, DeviceCommandInvocation):
                                    continue
                                ok = await self._deliver(dm, ev)
                                if ok:
                                    delivered.inc()
                                else:
                                    failed.inc()
                                    # the retry record must not vanish
                                    # into a cancelled produce: settled
                                    # on the broker's path or provably
                                    # withdrawn (then the redelivery
                                    # retries the invocation itself)
                                    await produce_settled(
                                        runtime.bus, undelivered_topic,
                                        ev, key=ev.device_id)
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:  # noqa: BLE001 - quarantined
                        await engine.dead_letter(record, exc, self.path)
                    # slotted-attribute reads cannot raise — bookkeeping
                    handled[(record.topic, record.partition)] = record.offset + 1  # swxlint: disable=DLQ01
                consumer.commit()
        finally:
            try:
                if handled:
                    # commit the handled prefix (see above)
                    consumer.commit(dict(handled))
            except RuntimeError:
                pass
            consumer.close()

    async def _deliver(self, dm, invocation: DeviceCommandInvocation) -> bool:
        engine = self.engine
        device = dm.get_device(invocation.device_id)
        if device is None:
            logger.warning("command for unknown device %s", invocation.device_id)
            return False
        dtype = dm.get_device_type(device.device_type_id)
        command = dm.get_device_command(invocation.command_id) \
            if invocation.command_id else None
        try:
            # route() raises on misconfigured encoder/provider names —
            # that's data too, not a reason to kill the delivery loop
            encoder, provider = engine.route(dtype.token if dtype else "")
            payload = encoder.encode(device, command, invocation)
            return await provider.deliver(device, payload)
        except Exception:  # noqa: BLE001 - delivery errors are data
            logger.exception("delivery failed for %s", device.token)
            return False


class CommandDeliveryService(Service):
    identifier = "command-delivery"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> CommandDeliveryEngine:
        return CommandDeliveryEngine(self, tenant)

    def delivery(self, tenant_id: str) -> CommandDeliveryEngine:
        return self.engine(tenant_id)  # type: ignore[return-value]
