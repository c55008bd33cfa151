"""event-sources service (reference: service-event-sources,
[SURVEY.md §2.2]): protocol receivers + payload decoders → decoded-events
topic.

The reference hosts MQTT/CoAP/AMQP/ActiveMQ/AzureEventHub/WebSocket/Socket
receivers and protobuf/JSON/Groovy decoders. Here:

- receivers: `QueueEventReceiver` (in-proc; the simulator's feed and the
  test double), `TcpEventReceiver` (length-prefixed SWB1 over TCP — the
  gateway protocol), and the protocol receivers `MqttEventReceiver`,
  `WebSocketEventReceiver`, `CoapEventReceiver`, `AmqpEventReceiver` and
  `StompEventReceiver`, each over its own listener (services/mqtt.py,
  websocket.py, coap.py, amqp.py, stomp.py).
- decoders: `Swb1Decoder` (columnar fast path — a few frombuffer views per
  batch), `JsonDecoder` (token-addressed cold path: per-event JSON like the
  reference's REST/MQTT JSON payloads, resolved to dense indices here).

Decoded batches are produced to the tenant's decoded-events topic; failed
decodes go to the failed-decode topic [SURVEY.md §3.2].
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Optional, Protocol

import numpy as np

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.batch import (
    BatchContext,
    LocationBatch,
    MeasurementBatch,
    RegistrationBatch,
)
from sitewhere_tpu_torch.domain.batch import (
    MAGIC,
    MSG_LOCATIONS,
    MSG_MEASUREMENTS,
    MSG_REGISTRATION,
    _HEADER,
)
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent, LifecycleComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine

logger = logging.getLogger(__name__)


class EventDecoder(Protocol):
    """(reference: IDeviceEventDecoder)"""

    def decode(self, payload: bytes, ctx: BatchContext) -> list: ...


def estimate_payload_events(payload: bytes) -> int:
    """Cheap event-count estimate for quota charging BEFORE decode: SWB1
    headers carry the batch count (one unpack, no array work); anything
    else (JSON, scripted framings) charges 1 per publish. Over-charging
    is impossible; JSON batches under-charge, which only softens — never
    bypasses — the quota."""
    if len(payload) >= _HEADER.size:
        try:
            magic, _mt, _flags, n = _HEADER.unpack_from(payload, 0)
            if magic == MAGIC:
                return max(int(n), 1)
        except Exception:  # noqa: BLE001 - estimation must never raise
            pass
    return 1


class Swb1Decoder:
    """Columnar fast path (reference analog: ProtobufDeviceEventDecoder)."""

    def decode(self, payload: bytes, ctx: BatchContext) -> list:
        magic, msg_type, _flags, _n = _HEADER.unpack_from(payload, 0)
        if magic != MAGIC:
            raise ValueError("bad SWB1 magic")
        if msg_type == MSG_MEASUREMENTS:
            return [MeasurementBatch.decode(payload, ctx)]
        if msg_type == MSG_LOCATIONS:
            return [LocationBatch.decode(payload, ctx)]
        if msg_type == MSG_REGISTRATION:  # compact agent protocol
            return [RegistrationBatch.decode(payload, ctx)]
        raise ValueError(f"unknown SWB1 message type {msg_type}")


class JsonDecoder:
    """Token-addressed JSON payloads (reference analog:
    JsonDeviceRequestDecoder). Shapes:

      {"requests": [{"type": "measurement", "device": "tok", "mtype": 0,
                     "value": 1.2, "ts": ...},
                    {"type": "location", "device": "tok", "lat": .., "lon": ..},
                    {"type": "registration", "device": "tok",
                     "deviceType": "ttok"}]}

    Device tokens are resolved to dense indices via the device-management
    engine; unknown tokens become registration requests (auto-registration
    path, [SURVEY.md §2.2 device-registration]).
    """

    def __init__(self, resolve_tokens):
        self._resolve = resolve_tokens  # Sequence[str] -> list[int]

    def decode(self, payload: bytes, ctx: BatchContext) -> list:
        doc = json.loads(payload)
        requests = doc.get("requests", [doc] if doc else [])
        return requests_to_batches(requests, ctx, self._resolve)


def requests_to_batches(requests: list, ctx: BatchContext,
                        resolve) -> list:
    """Token-addressed request dicts → columnar batches (shared by the
    JSON decoder and scripted decoders; `resolve` maps device tokens to
    dense indices, unknown tokens become auto-registration requests).

    Column extraction is ONE pass over the request dicts per batch kind
    (the old shape re-walked the batch once per column — four extra
    comprehension+zip traversals, charged per event at JSON-decode time;
    at 4096-event batches that was the decoder's dominant cost after the
    json.loads itself)."""
    meas, locs, out = [], [], []
    for r in requests:
        t = r.get("type", "measurement")
        if t == "measurement":
            meas.append(r)
        elif t == "location":
            locs.append(r)
        elif t == "registration":
            out.append(RegistrationBatch(
                ctx, [r["device"]], r.get("deviceType", ""),
                area_token=r.get("area"), metadata=r.get("metadata", {})))
        else:
            raise ValueError(f"unknown request type {t!r}")
    now = time.time()
    if meas:
        idx = resolve([r["device"] for r in meas])
        dev, mtype, value, ts = [], [], [], []
        for i, r in zip(idx, meas):  # single traversal builds every column
            if i < 0:
                # unknown token → auto-registration; its OTHER fields are
                # never read (a malformed value/ts on an unregistered
                # device must not poison the registered rows' columns)
                out.append(RegistrationBatch(ctx, [r["device"]], ""))
                continue
            dev.append(i)
            mtype.append(r.get("mtype", 0))
            value.append(r.get("value", 0.0))
            ts.append(r.get("ts", now))
        if dev:
            out.append(MeasurementBatch(
                ctx,
                np.asarray(dev, np.uint32),
                np.asarray(mtype, np.uint16),
                np.asarray(value, np.float32),
                np.asarray(ts, np.float64)))
    if locs:
        idx = resolve([r["device"] for r in locs])
        dev, lat, lon, elev, ts = [], [], [], [], []
        for i, r in zip(idx, locs):  # single traversal builds every column
            if i < 0:  # unknown token → auto-registration, like measurements
                out.append(RegistrationBatch(ctx, [r["device"]], ""))
                continue
            dev.append(i)
            lat.append(r.get("lat", 0.0))
            lon.append(r.get("lon", 0.0))
            elev.append(r.get("elevation", 0.0))
            ts.append(r.get("ts", now))
        if dev:
            out.append(LocationBatch(
                ctx,
                np.asarray(dev, np.uint32),
                np.asarray(lat, np.float64),
                np.asarray(lon, np.float64),
                np.asarray(elev, np.float32),
                np.asarray(ts, np.float64)))
    return out


class ScriptedDecoder:
    """Tenant-scripted payload decoder (reference analog:
    GroovyEventDecoder): the operator uploads a python script defining

        def decode(payload: bytes, ctx) -> list[dict]

    returning token-addressed request dicts (the JSON decoder's shape:
    {"type": "measurement"|"location"|"registration", "device": token,
    ...}); the shared `requests_to_batches` turns them columnar. The
    script is hot-reloadable through the engine's decoder ScriptManager
    — a gateway with a proprietary framing gets first-class ingest
    without forking the platform."""

    def __init__(self, manager, name: str, resolve_tokens):
        self._manager = manager     # lookup per decode → hot reload works
        self._name = name
        self._resolve = resolve_tokens

    def decode(self, payload: bytes, ctx: BatchContext) -> list:
        fn = self._manager.hook(self._name)
        requests = fn(payload, ctx)
        if not isinstance(requests, list):
            raise ValueError(
                f"decoder script {self._name!r} must return list[dict], "
                f"got {type(requests).__name__}")
        return requests_to_batches(requests, ctx, self._resolve)


class QueueEventReceiver(BackgroundTaskComponent):
    """In-proc receiver: payloads arrive on an asyncio.Queue
    (reference analog: an InboundEventReceiver; doubles as the test/bench
    ingress and the simulator's sink)."""

    def __init__(self, name: str, engine: "EventSourcesEngine",
                 decoder: EventDecoder, maxsize: int = 1024):
        super().__init__(name)
        self.engine = engine
        self.decoder = decoder
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=maxsize)

    async def submit(self, payload: bytes) -> bool:
        # quota charge at arrival (the in-proc analog of a protocol
        # error): a rejected payload never enters the queue, and the
        # caller learns it was shed
        if self.engine.admit_ingress(payload) > 0:
            # the reject path MUST suspend: accepted submits backpressure
            # through the bounded queue, but a reject is a sync return —
            # an in-process caller retrying in a tight loop would never
            # yield the event loop, starving the very settle/flush tasks
            # whose progress clears the overload that caused the reject
            # (a measured live-lock: scoring froze while a flood sender
            # spun on cheap rejects at 16M events/s)
            await asyncio.sleep(0)
            return False
        # ingest time is stamped at arrival so queue wait under load is
        # part of measured end-to-end latency (no flattering p99s)
        await self.queue.put((payload, time.monotonic()))
        return True

    def submit_nowait(self, payload: bytes) -> bool:
        if self.engine.admit_ingress(payload) > 0:
            return False
        self.queue.put_nowait((payload, time.monotonic()))
        return True

    # queued payloads were already charged at submit()/submit_nowait();
    # charging again here would double-bill every event
    async def _run(self) -> None:  # swxlint: disable=FLW01
        while True:
            payload, t_in = await self.queue.get()
            await self.engine.process_payload(payload, self.name, self.decoder,
                                              ingest_monotonic=t_in)
            # queue.get on a non-empty queue never suspends; yield so the
            # rest of the pipeline runs while we drain a deep backlog
            await asyncio.sleep(0)


class TcpEventReceiver(BackgroundTaskComponent):
    """Length-prefixed frames over TCP (u32 length + SWB1 body) — the
    gateway ingestion protocol (reference analog: the socket receiver)."""

    MAX_FRAME = 16 * 1024 * 1024  # hostile length prefixes can't buffer GiBs

    def __init__(self, name: str, engine: "EventSourcesEngine",
                 decoder: EventDecoder, host: str = "127.0.0.1", port: int = 0,
                 max_frame: Optional[int] = None):
        super().__init__(name)
        self.engine = engine
        self.decoder = decoder
        self.host, self.port = host, port
        self.max_frame = max_frame or self.MAX_FRAME
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.StreamWriter] = set()

    async def _do_start(self, monitor) -> None:
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self._conns.add(writer)
        try:
            while True:
                header = await reader.readexactly(4)
                length = int.from_bytes(header, "little")
                if length > self.max_frame:
                    logger.warning("%s: frame length %d exceeds max %d, dropping"
                                   " connection", self.name, length, self.max_frame)
                    break
                payload = await reader.readexactly(length)
                if self.engine.admit_ingress(payload) > 0:
                    # SWB1 has no response channel: the over-quota frame
                    # is dropped (counted in flow.rejected); the gateway
                    # protocol's backpressure is TCP itself
                    continue
                await self.engine.process_payload(payload, self.name, self.decoder,
                                                  ingest_monotonic=time.monotonic())
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _run(self) -> None:  # server runs itself; nothing to poll
        await asyncio.Event().wait()

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        from sitewhere_tpu_torch.kernel.net import shutdown_server

        # a connected gateway that never hangs up must not wedge the
        # tenant engine's shutdown (3.12 wait_closed semantics)
        await shutdown_server(self._server, self._conns)
        self._server = None


class MqttEventReceiver(BackgroundTaskComponent):
    """MQTT ingest endpoint (reference analog: MqttInboundEventReceiver).
    Hosts a minimal MQTT 3.1.1 server (services/mqtt.py) — any standard
    device client can CONNECT and PUBLISH SWB1/JSON payloads at QoS 0/1/2.
    The MQTT topic becomes the batch source.

    Security (receiver config):
    - `users: {username: password}` — when present, CONNECT must carry
      matching credentials or it is refused (CONNACK code 4).
    - command-topic isolation (always on): a client may only subscribe
    to its OWN command topic `<command_topic_prefix><client_id>`;
    filters reaching into the command space any other way (wildcards
    included) get SUBACK failure 0x80. Non-command topics stay open."""

    def __init__(self, name: str, engine: "EventSourcesEngine",
                 decoder: EventDecoder, host: str = "127.0.0.1",
                 port: int = 0, users: Optional[dict] = None,
                 command_topic_prefix: str = "swx/commands/",
                 require_client_id_match: bool = False,
                 subscribe_allow: Optional[list] = None):
        super().__init__(name)
        self.engine = engine
        self.decoder = decoder
        self.users = dict(users) if users else None
        self.command_topic_prefix = command_topic_prefix
        # broker fan-out means a subscription is an EAVESDROPPING grant:
        # by default a device may only hear its own command topic; the
        # operator opens telemetry/ops prefixes explicitly (e.g.
        # subscribe_allow: ["plant/", "ops/"])
        self.subscribe_allow = tuple(subscribe_allow or ())
        # per-device credentials mode: username must equal client_id, so
        # the client_id the own-command-topic rule trusts is the one the
        # password proved. Off by default for the gateway pattern (one
        # credential publishing many devices' telemetry) — gateways that
        # also subscribe to command topics should enable this.
        self.require_client_id_match = require_client_id_match
        from sitewhere_tpu_torch.services.mqtt import MqttListener

        self.listener = MqttListener(
            self._on_publish, host=host, port=port,
            authenticate=self._authenticate if self.users else None,
            authorize_sub=self._authorize_sub)

    def _authenticate(self, client_id: str, username, password) -> bool:
        if username is None or self.users.get(username) != password:
            return False
        return not self.require_client_id_match or username == client_id

    def _authorize_sub(self, client_id: str, topic_filter: str) -> bool:
        if topic_filter == f"{self.command_topic_prefix}{client_id}":
            return True  # a device's own command topic
        # everything else is default-DENY: with broker fan-out live, any
        # other subscription would receive peers' telemetry (or, with a
        # wildcard, the whole command space). The operator opens
        # specific prefixes via `subscribe_allow`; wildcards must stay
        # inside an allowed prefix.
        for allowed in self.subscribe_allow:
            if topic_filter.startswith(allowed) and "#" not in allowed:
                # '#'/'+' are fine *after* the allowed prefix; reject
                # filters whose wildcards sit before the prefix ends
                return True
        return False

    @property
    def port(self) -> int:
        return self.listener.port

    async def _on_publish(self, topic: str, payload: bytes,
                          client_id: str) -> bool:
        # MQTT 3.1.1 has no per-PUBLISH error code: over-quota publishes
        # are refused (False → the listener skips peer fan-out and counts
        # the reject); QoS1/2 still get their PUBACK/PUBREC — transport
        # acceptance, not pipeline admission — which is the
        # protocol-appropriate behavior short of disconnecting
        if self.engine.admit_ingress(payload) > 0:
            return False
        await self.engine.process_payload(
            payload, f"{self.name}:{topic}", self.decoder,
            ingest_monotonic=time.monotonic())
        return True

    async def _do_start(self, monitor) -> None:
        await self.listener.start()

    async def _run(self) -> None:  # server runs itself
        await asyncio.Event().wait()

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        await self.listener.stop()


class WebSocketEventReceiver(BackgroundTaskComponent):
    """WebSocket ingest endpoint (reference analog: the WebSocket
    receiver): devices connect to ws://host:port/ws/<client-id> and send
    binary SWB1 (or JSON) messages; server→client frames carry command
    downlink via the session registry (services/websocket.py).

    `tokens: {client_id: token}` — when present, the Upgrade must carry
    `Authorization: Bearer <token>` (or `?token=`) matching the client
    id in the path; otherwise 401. The session registry routes command
    downlink by client id (and ids are printed in QR labels), so an
    unauthenticated peer must never occupy one — same trust model the
    MQTT endpoint enforces at CONNECT."""

    def __init__(self, name: str, engine: "EventSourcesEngine",
                 decoder: EventDecoder, host: str = "127.0.0.1",
                 port: int = 0, tokens: Optional[dict] = None):
        super().__init__(name)
        self.engine = engine
        self.decoder = decoder
        self.tokens = dict(tokens) if tokens else None
        from sitewhere_tpu_torch.services.websocket import WebSocketListener

        self.listener = WebSocketListener(
            self._on_message, host=host, port=port,
            authenticate=self._authenticate if self.tokens else None)

    def _authenticate(self, client_id: str, token) -> bool:
        return token is not None and self.tokens.get(client_id) == token

    @property
    def port(self) -> int:
        return self.listener.port

    async def _on_message(self, payload: bytes, client_id: str) -> bool:
        # False → the listener closes the connection with 1013 ("try
        # again later"), the WebSocket-appropriate over-quota signal
        if self.engine.admit_ingress(payload) > 0:
            return False
        await self.engine.process_payload(
            payload, f"{self.name}:{client_id}", self.decoder,
            ingest_monotonic=time.monotonic())
        return True

    async def _do_start(self, monitor) -> None:
        await self.listener.start()

    async def _run(self) -> None:  # server runs itself
        await asyncio.Event().wait()

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        await self.listener.stop()


class CoapEventReceiver(BackgroundTaskComponent):
    """CoAP ingest endpoint (reference analog: the Californium-based
    CoAP receiver): constrained devices POST SWB1 (or JSON) payloads to
    coap://host:port/<path> over UDP; CON requests are ACKed and
    deduplicated, malformed datagrams are counted and dropped
    (services/coap.py)."""

    def __init__(self, name: str, engine: "EventSourcesEngine",
                 decoder: EventDecoder, host: str = "127.0.0.1",
                 port: int = 0, path: str = "telemetry",
                 secret: Optional[str] = None):
        super().__init__(name)
        self.engine = engine
        self.decoder = decoder
        from sitewhere_tpu_torch.services.coap import CoapListener

        # `admit` answers BEFORE the ACK so an over-quota POST gets the
        # CoAP-appropriate 4.29 Too Many Requests (RFC 8516) + Max-Age
        self.listener = CoapListener(self._on_payload, host=host, port=port,
                                     path=path, secret=secret,
                                     admit=self._admit)

    def _admit(self, payload: bytes) -> float:
        return self.engine.admit_ingress(payload)

    @property
    def port(self) -> int:
        return self.listener.port

    async def _on_payload(self, payload: bytes, source: str) -> None:
        await self.engine.process_payload(
            payload, f"{self.name}:{source}", self.decoder,
            ingest_monotonic=time.monotonic())

    async def _do_start(self, monitor) -> None:
        await self.listener.start()

    async def _run(self) -> None:  # server runs itself
        await asyncio.Event().wait()

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        await self.listener.stop()


class _BrokerEventReceiver(BackgroundTaskComponent):
    """Shared shape for broker-style endpoints whose listener calls
    `on_message(key, payload, source)` and takes a credential-checking
    `authenticate(user, secret)` hook (AMQP, STOMP): one copy of the
    auth/port/process-payload/lifecycle plumbing, subclasses supply the
    listener class."""

    LISTENER = None   # subclass: callable(on_message, host, port, authenticate)

    def __init__(self, name: str, engine: "EventSourcesEngine",
                 decoder: EventDecoder, host: str = "127.0.0.1",
                 port: int = 0, users: Optional[dict] = None):
        super().__init__(name)
        self.engine = engine
        self.decoder = decoder
        self.users = dict(users) if users else None
        self.listener = type(self).LISTENER(
            self._on_message, host=host, port=port,
            authenticate=self._authenticate if self.users else None)

    def _authenticate(self, username: str, password: str) -> bool:
        return self.users.get(username) == password

    @property
    def port(self) -> int:
        return self.listener.port

    async def _on_message(self, key: str, payload: bytes,
                          source: str) -> bool:
        # False → AMQP answers confirm-mode publishers with basic.nack;
        # STOMP answers an ERROR frame (each listener's protocol-
        # appropriate over-quota signal)
        if self.engine.admit_ingress(payload) > 0:
            return False
        await self.engine.process_payload(
            payload, f"{self.name}:{key}", self.decoder,
            ingest_monotonic=time.monotonic())
        return True

    async def _do_start(self, monitor) -> None:
        await self.listener.start()

    async def _run(self) -> None:  # server runs itself
        await asyncio.Event().wait()

    async def _do_stop(self, monitor) -> None:
        await super()._do_stop(monitor)
        await self.listener.stop()


def _amqp_listener(*a, **k):
    from sitewhere_tpu_torch.services.amqp import AmqpListener

    return AmqpListener(*a, **k)


def _stomp_listener(*a, **k):
    from sitewhere_tpu_torch.services.stomp import StompListener

    return StompListener(*a, **k)


class AmqpEventReceiver(_BrokerEventReceiver):
    """AMQP 0-9-1 ingest endpoint (reference analog: the RabbitMQ
    inbound receiver): hosts a minimal AMQP server (services/amqp.py) —
    any standard client (pika, amqplib, gateway SDKs) can connect, open
    a channel and `basic.publish` SWB1/JSON payloads; confirm-mode
    publishers get `basic.ack` (at-least-once). The routing key becomes
    the batch source. `users: {username: password}` enables PLAIN auth
    (unauthenticated connections are refused with 403)."""

    LISTENER = staticmethod(_amqp_listener)


class StompEventReceiver(_BrokerEventReceiver):
    """STOMP 1.2 ingest endpoint (reference analog: the ActiveMQ
    inbound receiver — STOMP is ActiveMQ/Artemis' interoperable wire
    protocol): clients CONNECT and SEND SWB1/JSON bodies; the
    destination header becomes the batch source; `receipt` headers are
    honored (at-least-once handshake). `users: {login: passcode}`
    enables auth."""

    LISTENER = staticmethod(_stomp_listener)


class EventSourcesEngine(TenantEngine):
    """Per-tenant receiver fleet + decode → decoded-events topic."""

    def __init__(self, service: "EventSourcesService", tenant: TenantConfig):
        super().__init__(service, tenant)
        self._decoded_topic = self.tenant_topic(TopicNaming.EVENT_SOURCE_DECODED)
        self._failed_topic = self.tenant_topic(TopicNaming.EVENT_SOURCE_FAILED)
        self._events_in = service.metrics.meter("event_sources.events_received")
        self._decode_failures = service.metrics.counter("event_sources.decode_failures")
        self._quota_rejected = service.metrics.counter(
            "event_sources.quota_rejected")
        self.receivers: list[LifecycleComponent] = []
        cfg = tenant.section("event-sources", {"receivers": [{"kind": "queue",
                                                              "decoder": "swb1",
                                                              "name": "default"}]})
        # decoder scripts (reference: GroovyEventDecoder): hot-reloadable
        # `def decode(payload, ctx) -> list[dict]`, referenced by
        # receivers as decoder "script:<name>"
        from sitewhere_tpu_torch.kernel.scripting import ScriptManager

        self.decoder_scripts = ScriptManager(
            self.tenant_id, entrypoint="decode", require_async=False)
        for name, source in cfg.get("scripts", {}).items():
            self.decoder_scripts.put(name, source)
        for rc in cfg.get("receivers", []):
            self.add_receiver(rc)

    def put_decoder_script(self, name: str, source: str):
        """Upload/hot-reload a decoder script (live receivers using
        `script:<name>` pick the new version up on their next decode)."""
        return self.decoder_scripts.put(name, source)

    def delete_decoder_script(self, name: str):
        """Delete a decoder script — refused while a live receiver still
        references it (deleting under a receiver would silently shunt
        ALL of its traffic to the failed topic until re-upload)."""
        holders = [r.name for r in self.receivers
                   if isinstance(getattr(r, "decoder", None),
                                 ScriptedDecoder)
                   and r.decoder._name == name]
        if holders:
            raise ValueError(
                f"decoder script {name!r} is in use by receiver(s) "
                f"{holders}; remove them first")
        return self.decoder_scripts.delete(name)

    def _resolve_tokens(self):
        dm = self.runtime.api("device-management")
        tenant_id = self.tenant_id

        def resolve(tokens):
            return dm.management(tenant_id).tokens_to_indices(tokens)

        return resolve

    def _make_decoder(self, kind: str) -> EventDecoder:
        if kind == "swb1":
            return Swb1Decoder()
        if kind == "json":
            return JsonDecoder(self._resolve_tokens())
        if kind.startswith("script:"):
            name = kind.split(":", 1)[1]
            if self.decoder_scripts.get(name) is None:
                raise ValueError(f"decoder script {name!r} not uploaded")
            return ScriptedDecoder(self.decoder_scripts, name,
                                   self._resolve_tokens())
        raise ValueError(f"unknown decoder {kind!r}")

    def add_receiver(self, cfg: dict) -> LifecycleComponent:
        decoder = self._make_decoder(cfg.get("decoder", "swb1"))
        kind = cfg.get("kind", "queue")
        name = cfg.get("name")
        if name is None:
            # generated names must not collide with survivors of earlier
            # deletions (len(receivers) alone can repeat after removal)
            taken = {r.name for r in self.receivers}
            n = len(self.receivers)
            while f"{kind}-{n}" in taken:
                n += 1
            name = f"{kind}-{n}"
        if kind == "queue":
            r = QueueEventReceiver(name, self, decoder,
                                   maxsize=cfg.get("maxsize", 1024))
        elif kind == "tcp":
            r = TcpEventReceiver(name, self, decoder,
                                 host=cfg.get("host", "127.0.0.1"),
                                 port=cfg.get("port", 0))
        elif kind == "mqtt":
            r = MqttEventReceiver(
                name, self, decoder,
                host=cfg.get("host", "127.0.0.1"), port=cfg.get("port", 0),
                users=cfg.get("users"),
                command_topic_prefix=cfg.get("command_topic_prefix",
                                             "swx/commands/"),
                require_client_id_match=cfg.get("require_client_id_match",
                                                False),
                subscribe_allow=cfg.get("subscribe_allow"))
        elif kind == "websocket":
            r = WebSocketEventReceiver(name, self, decoder,
                                       host=cfg.get("host", "127.0.0.1"),
                                       port=cfg.get("port", 0),
                                       tokens=cfg.get("tokens"))
        elif kind == "coap":
            r = CoapEventReceiver(name, self, decoder,
                                  host=cfg.get("host", "127.0.0.1"),
                                  port=cfg.get("port", 0),
                                  path=cfg.get("path", "telemetry"),
                                  secret=cfg.get("secret"))
        elif kind == "amqp":
            r = AmqpEventReceiver(name, self, decoder,
                                  host=cfg.get("host", "127.0.0.1"),
                                  port=cfg.get("port", 0),
                                  users=cfg.get("users"))
        elif kind == "stomp":
            r = StompEventReceiver(name, self, decoder,
                                   host=cfg.get("host", "127.0.0.1"),
                                   port=cfg.get("port", 0),
                                   users=cfg.get("users"))
        else:
            raise ValueError(f"unknown receiver kind {kind!r}")
        self.receivers.append(r)
        self.add_child(r)
        return r

    async def remove_receiver(self, name: str) -> bool:
        """Stop and detach one receiver (dynamic source management —
        the reference's analog is an event-sources config update +
        engine restart; here single receivers come and go live)."""
        for r in self.receivers:
            if r.name == name:
                try:
                    await r.stop()
                finally:
                    # detach even when stop fails (an errored receiver
                    # must not squat its name forever)
                    self.receivers.remove(r)
                    self.remove_child(r)
                return True
        return False

    def receiver(self, name: str):
        for r in self.receivers:
            if r.name == name:
                return r
        raise KeyError(name)

    def admit_ingress(self, payload: bytes) -> float:
        """Charge this payload against the tenant's ingress quota
        (kernel/flow.py). Returns 0.0 when admitted, else the seconds a
        well-behaved publisher should wait before retrying — the caller
        answers its protocol's over-quota error and must NOT decode or
        produce the payload."""
        flow = getattr(self.runtime, "flow", None)
        if flow is None:
            return 0.0
        decision = flow.admit_ingress(self.tenant_id,
                                      estimate_payload_events(payload))
        if decision.admitted:
            return 0.0
        self._quota_rejected.inc()
        return max(decision.retry_after, 0.001)

    # the shared POST-admission sink: every receiver charges
    # admit_ingress() before invoking this (swx lint FLW01 enforces
    # that at each call site) — charging here too would double-bill
    async def process_payload(self, payload: bytes, source: str,  # swxlint: disable=FLW01
                              decoder: EventDecoder,
                              ingest_monotonic: Optional[float] = None) -> None:
        tracer = self.runtime.tracer
        ctx = BatchContext(tenant_id=self.tenant_id, source=source,
                           trace_id=tracer.new_trace_id())
        if ingest_monotonic is not None:
            ctx.ingest_monotonic = ingest_monotonic
        try:
            with tracer.span("event-sources.decode", self.tenant_id,
                             ctx.trace_id) as decode:
                batches = decoder.decode(payload, ctx)
                decode.n_events = n_decoded = sum(len(b) for b in batches)
        except Exception as exc:  # noqa: BLE001 - failed decode is data, not a crash
            self._decode_failures.inc()
            await self.runtime.bus.produce(
                self._failed_topic, {"payload": payload, "error": repr(exc),
                                     "source": source})
            return
        # the spine's first span: receiver arrival (ingest_monotonic,
        # stamped at the socket/queue edge) → decode start — pure queue
        # wait at the receiving edge, zero when the receiver decodes
        # inline
        tracer.record(ctx.trace_id, "event-sources.receive",
                      self.tenant_id, ctx.ingest_monotonic,
                      max(decode.t_start - ctx.ingest_monotonic, 0.0),
                      n_decoded)
        for batch in batches:
            n = len(batch)
            if n:
                self._events_in.mark(n)
            # keyed by source: one source's stream stays partition-ordered
            # through the whole pipeline (Kafka's ordering model)
            await self.runtime.bus.produce(self._decoded_topic, batch, key=source)


class EventSourcesService(Service):
    identifier = "event-sources"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> EventSourcesEngine:
        return EventSourcesEngine(self, tenant)
