"""Protocol clients for the device simulator: one `Sender` per hosted
ingest endpoint, so `swx simulate --protocol ...` (and tests) can drive
ANY transport the platform serves — TCP gateway framing, MQTT 3.1.1
PUBLISH, CoAP POST, WebSocket binary frames, AMQP 0-9-1 basic.publish.

Each sender speaks the same minimal wire subset a real constrained
device/gateway SDK would; payload bytes are whatever the endpoint's
configured decoder expects (SWB1 by default).
"""

from __future__ import annotations

import asyncio
import base64
import os
import struct
from typing import Optional

from sitewhere_tpu_torch.services.amqp import _longstr, _method, _shortstr
from sitewhere_tpu_torch.services.coap import CODE_POST, TYPE_NON, build_request
from sitewhere_tpu_torch.services.mqtt import _packet as _mqtt_packet


async def _close_writer(writer: Optional[asyncio.StreamWriter]) -> None:
    """Flush-then-close: writer.close() alone can drop buffered tail
    data when the event loop tears down right after cmd_simulate
    returns (the last ~64 KB would be counted as sent but never reach
    the wire)."""
    if writer is None:
        return
    try:
        await writer.drain()
    except ConnectionError:
        pass
    writer.close()
    try:
        await writer.wait_closed()
    except (ConnectionError, asyncio.CancelledError):
        pass


class TcpSender:
    """u32-LE length prefix + body (the gateway protocol)."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> None:
        _, self._writer = await asyncio.open_connection(self.host, self.port)

    async def send(self, payload: bytes) -> None:
        self._writer.write(len(payload).to_bytes(4, "little") + payload)
        await self._writer.drain()

    async def close(self) -> None:
        await _close_writer(self._writer)


class MqttSender:
    """Minimal MQTT 3.1.1 client: CONNECT (optional username/password),
    QoS0 PUBLISH to `topic`."""

    def __init__(self, host: str, port: int, client_id: str = "swx-sim",
                 topic: str = "telemetry", username: Optional[str] = None,
                 password: Optional[str] = None):
        self.host, self.port = host, port
        self.client_id, self.topic = client_id, topic
        self.username, self.password = username, password
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    @staticmethod
    def _mqtt_str(s: str) -> bytes:
        b = s.encode()
        return struct.pack(">H", len(b)) + b

    @staticmethod
    def _packet(ptype: int, body: bytes) -> bytes:
        # server-side framing helper reused (services/mqtt.py): one
        # remaining-length encoder to interoperate with
        return _mqtt_packet(ptype >> 4, ptype & 0x0F, body)

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        flags = 0x02                       # clean session
        tail = b""
        if self.username is not None:
            flags |= 0x80
            tail += self._mqtt_str(self.username)
        if self.password is not None:
            flags |= 0x40
            tail += self._mqtt_str(self.password)
        body = (self._mqtt_str("MQTT") + bytes([4, flags])
                + struct.pack(">H", 60) + self._mqtt_str(self.client_id)
                + tail)
        self._writer.write(self._packet(0x10, body))
        await self._writer.drain()
        head = await asyncio.wait_for(self._reader.readexactly(4), 10.0)
        if head[0] != 0x20 or head[3] != 0:
            raise ConnectionError(f"MQTT CONNECT refused (code {head[3]})")

    async def send(self, payload: bytes) -> None:
        body = self._mqtt_str(self.topic) + payload   # QoS0: no packet id
        self._writer.write(self._packet(0x30, body))
        await self._writer.drain()

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.write(self._packet(0xE0, b""))   # DISCONNECT
        await _close_writer(self._writer)


class CoapSender:
    """NON (fire-and-forget) CoAP POSTs — the constrained-device load
    shape; use services.coap.coap_post for confirmable one-shots."""

    MAX_PAYLOAD = 60_000    # one UDP datagram (65,507 B) minus headroom

    def __init__(self, host: str, port: int, path: str = "telemetry",
                 secret: Optional[str] = None):
        self.host, self.port = host, port
        self.path = path
        self.secret = secret
        self._transport = None
        self._mid = 0
        self._error: Optional[Exception] = None

    async def connect(self) -> None:
        loop = asyncio.get_running_loop()
        sender = self

        class _P(asyncio.DatagramProtocol):
            def datagram_received(self, data, addr):  # ACK/RST: ignored
                pass

            def error_received(self, exc):
                # EMSGSIZE/ICMP errors must not be silently eaten: the
                # next send() raises instead of counting ghosts
                sender._error = exc

        self._transport, _ = await loop.create_datagram_endpoint(
            _P, remote_addr=(self.host, self.port))

    async def send(self, payload: bytes) -> None:
        if self._error is not None:
            raise ConnectionError(f"coap transport error: {self._error}")
        if len(payload) > self.MAX_PAYLOAD:
            raise ValueError(
                f"coap payload {len(payload)} B exceeds one UDP datagram "
                f"(~{self.MAX_PAYLOAD} B) — use fewer devices per batch "
                f"(SWB1 is ~18 B/device) or a stream transport")
        self._mid = (self._mid + 1) % 0x10000
        self._transport.sendto(build_request(
            CODE_POST, self._mid, self._mid.to_bytes(2, "big"),
            self.path, payload, mtype=TYPE_NON,
            query=f"token={self.secret}" if self.secret is not None else None))

    async def close(self) -> None:
        if self._transport is not None:
            self._transport.close()


class WebSocketSender:
    """RFC 6455 client: Upgrade handshake, masked binary frames."""

    def __init__(self, host: str, port: int, client_id: str = "swx-sim",
                 token: Optional[str] = None):
        self.host, self.port = host, port
        self.client_id, self.token = client_id, token
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> None:
        reader, writer = await asyncio.open_connection(self.host, self.port)
        key = base64.b64encode(os.urandom(16)).decode()
        auth = (f"Authorization: Bearer {self.token}\r\n"
                if self.token else "")
        writer.write((f"GET /ws/{self.client_id} HTTP/1.1\r\nHost: x\r\n"
                      f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Key: {key}\r\n"
                      f"Sec-WebSocket-Version: 13\r\n{auth}\r\n").encode())
        await writer.drain()
        resp = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"), 10.0)
        status = resp.split(b"\r\n", 1)[0].decode()
        if "101" not in status:
            raise ConnectionError(f"WebSocket upgrade refused: {status}")
        self._writer = writer

    async def send(self, payload: bytes) -> None:
        mask = os.urandom(4)
        head = bytearray([0x80 | 0x2])     # FIN + binary
        n = len(payload)
        if n < 126:
            head.append(0x80 | n)
        elif n < 65536:
            head.append(0x80 | 126)
            head += struct.pack(">H", n)
        else:
            head.append(0x80 | 127)
            head += struct.pack(">Q", n)
        head += mask
        # vectorized masking: int XOR over the whole payload (the
        # byte-at-a-time python loop would dominate unthrottled runs)
        reps = (n + 3) // 4
        body = (int.from_bytes(payload, "big")
                ^ (int.from_bytes(mask * reps, "big") >> (8 * (4 * reps - n)))
                ).to_bytes(n, "big")
        self._writer.write(bytes(head) + body)
        await self._writer.drain()

    async def close(self) -> None:
        await _close_writer(self._writer)


class AmqpSender:
    """Minimal AMQP 0-9-1 publisher: PLAIN auth, channel 1,
    basic.publish with routing key."""

    def __init__(self, host: str, port: int, routing_key: str = "telemetry",
                 username: str = "guest", password: str = "guest"):
        self.host, self.port = host, port
        self.routing_key = routing_key
        self.username, self.password = username, password
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    # argument encoders reused from the server module (services/amqp.py)
    _ss = staticmethod(_shortstr)
    _method = staticmethod(_method)

    @staticmethod
    def _frame(ftype: int, channel: int, payload: bytes) -> bytes:
        return (struct.pack(">BHI", ftype, channel, len(payload))
                + payload + b"\xce")

    async def _expect(self, class_id: int, method_id: int) -> bytes:
        while True:
            head = await asyncio.wait_for(self._reader.readexactly(7), 10.0)
            ftype, _, size = struct.unpack(">BHI", head)
            payload = await asyncio.wait_for(
                self._reader.readexactly(size + 1), 10.0)
            if ftype == 8:                 # heartbeat
                continue
            got = struct.unpack_from(">HH", payload, 0)
            if got != (class_id, method_id):
                raise ConnectionError(f"AMQP: expected "
                                      f"{class_id}.{method_id}, got {got}")
            return payload[4:-1]

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        w = self._writer
        w.write(b"AMQP\x00\x00\x09\x01")
        await self._expect(10, 10)         # start
        plain = b"\x00" + self.username.encode() + b"\x00" \
            + self.password.encode()
        w.write(self._frame(1, 0, self._method(
            10, 11, struct.pack(">I", 0) + self._ss("PLAIN")
            + _longstr(plain) + self._ss("en_US"))))
        await self._expect(10, 30)         # tune
        w.write(self._frame(1, 0, self._method(
            10, 31, struct.pack(">HIH", 0, 131072, 0))))
        w.write(self._frame(1, 0, self._method(
            10, 40, self._ss("/") + self._ss("") + b"\x00")))
        await self._expect(10, 41)         # open-ok
        w.write(self._frame(1, 1, self._method(20, 10, self._ss(""))))
        await self._expect(20, 11)         # channel open-ok
        await w.drain()

    async def send(self, payload: bytes) -> None:
        publish = self._method(60, 40, struct.pack(">H", 0) + self._ss("")
                               + self._ss(self.routing_key) + b"\x00")
        header = struct.pack(">HHQH", 60, 0, len(payload), 0)
        self._writer.write(self._frame(1, 1, publish)
                           + self._frame(2, 1, header)
                           + self._frame(3, 1, payload))
        await self._writer.drain()

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.write(self._frame(1, 0, self._method(
                10, 50, struct.pack(">H", 200) + self._ss("bye")
                + struct.pack(">HH", 0, 0))))
        await _close_writer(self._writer)


class StompSender:
    """STOMP 1.2 publisher: CONNECT (optional login/passcode), SEND
    with content-length binary bodies."""

    def __init__(self, host: str, port: int, destination: str = "telemetry",
                 username: Optional[str] = None,
                 password: Optional[str] = None):
        self.host, self.port = host, port
        self.destination = destination
        self.username, self.password = username, password
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        creds = ""
        if self.username is not None:
            creds = (f"login:{self.username}\n"
                     f"passcode:{self.password or ''}\n")
        self._writer.write(
            f"CONNECT\naccept-version:1.2\n{creds}\n".encode() + b"\x00")
        await self._writer.drain()
        reply = await asyncio.wait_for(
            self._reader.readuntil(b"\x00"), 10.0)
        if not reply.startswith(b"CONNECTED"):
            # split hoisted out of the f-string: \x0a inside an f-string
            # expression is a SyntaxError before Python 3.12
            first_line = reply.split(b"\x0a", 1)[0]
            raise ConnectionError(f"STOMP refused: {first_line!r}")

    async def send(self, payload: bytes) -> None:
        self._writer.write(
            (f"SEND\ndestination:{self.destination}\n"
             f"content-length:{len(payload)}\n\n").encode()
            + payload + b"\x00")
        await self._writer.drain()

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.write(b"DISCONNECT\n\n\x00")
        await _close_writer(self._writer)


SENDERS = {"tcp": TcpSender, "mqtt": MqttSender, "coap": CoapSender,
           "websocket": WebSocketSender, "amqp": AmqpSender,
           "stomp": StompSender}


def make_sender(protocol: str, host: str, port: int, **kw):
    try:
        cls = SENDERS[protocol]
    except KeyError:
        raise ValueError(f"unknown protocol {protocol!r} "
                         f"(known: {sorted(SENDERS)})") from None
    return cls(host, port, **kw)
