"""The protocol receivers on both packages, byte for byte on the wire.

For each protocol (MQTT, WebSocket, CoAP, AMQP, STOMP) and each case, the
same scripted client conversation goes to the receiver in a JAX-package
runtime and to the receiver in a port runtime (`device="cpu"`), each
hosting the event-sources service with the same tenant config, users,
tokens, secret and quota. Compared: every byte the endpoint answered,
the batches on the tenant's decoded topic (source, device_index, mtype,
value, ts), the failed-decode records, and the reject and malformed
counters. The frames follow the JAX package's own protocol tests
(tests/test_mqtt.py, tests/test_agent_protocol.py,
tests/test_protocol_fuzz.py); each conversation ends in a request whose
answer proves the endpoint handled everything before it. Every listener
binds port 0, and every await has its own `asyncio.wait_for` limit.
"""

import asyncio
import base64
import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu import services as jservices
from sitewhere_tpu.kernel import bus as jbus
from sitewhere_tpu.kernel import service as jservice
from sitewhere_tpu.sim import simulator as jsim
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch import services as tservices
from sitewhere_tpu_torch.kernel import bus as tbus
from sitewhere_tpu_torch.kernel import service as tservice

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(config=jconfig, services=jservices, bus=jbus,
                      service=jservice, settings={})
PORT = SimpleNamespace(config=tconfig, services=tservices, bus=tbus,
                       service=tservice, settings={"device": "cpu"})

STEP = 10.0         # limit on any one await (s)
FUZZ_FRAMES = 500
# one admitted 5-event publish, then a 20-event one over the 10-event
# burst: refused with a retry-after of ≈15,000 s (a refill of 0.001
# events/s keeps the hint the same to the second on both sides)
QUOTA = {"rate": 0.001, "burst": 10}


def _payload(n: int, k: int = 0) -> bytes:
    sim = jsim.DeviceSimulator(jsim.SimConfig(num_devices=n, seed=5 + k))
    return sim.payload(t=1000.0 + 60.0 * k)[0]


P0, P1, P2 = _payload(20, 0), _payload(20, 1), _payload(20, 2)
SMALL = _payload(5, 3)
GARBAGE = b"not swb1 at all"


async def _w(aw, timeout: float = STEP):
    return await asyncio.wait_for(aw, timeout)


class Ctx:
    """What one conversation saw: the endpoint's answers in order, and
    client addresses to replace by a placeholder (CoAP names the batch
    source after the client's ephemeral port)."""

    def __init__(self, receiver):
        self.receiver = receiver
        self.port = receiver.port
        self.log: list[tuple[str, bytes]] = []
        self.aliases: dict[str, str] = {}

    def rec(self, label: str, data: bytes) -> None:
        self.log.append((label, bytes(data)))

    async def tcp(self):
        return await _w(asyncio.open_connection("127.0.0.1", self.port))

    async def eof(self, label: str, reader, writer) -> None:
        """Half-close, then record whatever the endpoint still sends
        until it closes."""
        if writer.can_write_eof():
            writer.write_eof()
        self.rec(label, await _w(reader.read()))
        writer.close()


# -- MQTT 3.1.1 ----------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte, n = n % 128, n // 128
        out.append(byte | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _utf8(s: str) -> bytes:
    b = s.encode()
    return len(b).to_bytes(2, "big") + b


def _mqtt(ptype: int, flags: int, body: bytes) -> bytes:
    return bytes([(ptype << 4) | flags]) + _varint(len(body)) + body


def _connect(client_id: str, user=None, password=None) -> bytes:
    flags = 0x02 | (0x80 if user is not None else 0) | (
        0x40 if password is not None else 0)
    body = _utf8("MQTT") + bytes([4, flags]) + (60).to_bytes(2, "big") \
        + _utf8(client_id)
    if user is not None:
        body += _utf8(user)
    if password is not None:
        body += _utf8(password)
    return _mqtt(1, 0, body)


def _publish(topic: str, payload: bytes, qos: int = 0, packet_id: int = 1,
             dup: bool = False) -> bytes:
    body = _utf8(topic) + (packet_id.to_bytes(2, "big") if qos else b"")
    return _mqtt(3, (qos << 1) | (0x08 if dup else 0), body + payload)


def _subscribe(topic: str, packet_id: int = 7) -> bytes:
    return _mqtt(8, 2, packet_id.to_bytes(2, "big") + _utf8(topic) + b"\x00")


PINGREQ = _mqtt(12, 0, b"")
DISCONNECT = _mqtt(14, 0, b"")


async def _mqtt_read(reader) -> bytes:
    out = bytearray(await _w(reader.readexactly(1)))
    while True:
        b = await _w(reader.readexactly(1))
        out += b
        if not b[0] & 0x80:
            break
    length, mult = 0, 1
    for b in out[1:]:
        length += (b & 0x7F) * mult
        mult *= 128
    if length:
        out += await _w(reader.readexactly(length))
    return bytes(out)


async def _mqtt_step(ctx, label, reader, writer, data, answers=1):
    writer.write(data)
    await _w(writer.drain())
    for i in range(answers):
        ctx.rec(f"{label}.{i}", await _mqtt_read(reader))


async def mqtt_publish(ctx):
    r, w = await ctx.tcp()
    await _mqtt_step(ctx, "connect", r, w, _connect("gw-0"))
    await _mqtt_step(ctx, "qos0", r, w, _publish("telemetry/gw-0", P0), 0)
    await _mqtt_step(ctx, "qos1", r, w,
                     _publish("telemetry/gw-0", P1, qos=1, packet_id=10))
    await _mqtt_step(ctx, "garbage", r, w, _publish("telemetry/gw-0",
                                                    GARBAGE), 0)
    await _mqtt_step(ctx, "ping", r, w, PINGREQ)
    w.write(DISCONNECT)
    await ctx.eof("disconnect", r, w)


async def mqtt_qos2(ctx):
    r, w = await ctx.tcp()
    await _mqtt_step(ctx, "connect", r, w, _connect("gw-q2"))
    pub = _publish("telemetry/gw-q2", P0, qos=2, packet_id=9)
    await _mqtt_step(ctx, "publish", r, w, pub)
    # a retransmit before PUBREL: PUBREC again, not ingested again
    await _mqtt_step(ctx, "retransmit", r, w, _publish(
        "telemetry/gw-q2", P0, qos=2, packet_id=9, dup=True))
    await _mqtt_step(ctx, "pubrel", r, w, _mqtt(6, 2, (9).to_bytes(2, "big")))
    # the same id after PUBCOMP is a new message
    await _mqtt_step(ctx, "again", r, w, pub)
    await _mqtt_step(ctx, "ping", r, w, PINGREQ)
    await ctx.eof("close", r, w)


async def mqtt_credentials(ctx):
    for label, pkt in (("none", _connect("dev-1")),
                       ("wrong", _connect("dev-1", "gw", "nope")),
                       ("hostile-id", _connect("#", "gw", "s3cret")),
                       ("bad-level", _mqtt(1, 0, _utf8("MQTT") + bytes(
                           [3, 2]) + (60).to_bytes(2, "big")
                           + _utf8("dev-1")))):
        r, w = await ctx.tcp()
        w.write(pkt)
        await ctx.eof(label, r, w)
    r, w = await ctx.tcp()
    await _mqtt_step(ctx, "right", r, w, _connect("dev-1", "gw", "s3cret"))
    await _mqtt_step(ctx, "qos1", r, w,
                     _publish("telemetry/dev-1", P0, qos=1, packet_id=3))
    await _mqtt_step(ctx, "ping", r, w, PINGREQ)
    await ctx.eof("close", r, w)


async def mqtt_subscriptions(ctx):
    r, w = await ctx.tcp()
    await _mqtt_step(ctx, "connect", r, w, _connect("dev-1"))
    for i, topic in enumerate(("swx/commands/dev-1", "swx/commands/dev-2",
                               "swx/commands/#", "#", "swx/+/dev-2",
                               "swx/telemetry/x", "plant/#", "plant/a")):
        await _mqtt_step(ctx, topic, r, w, _subscribe(topic, 20 + i))
    await _mqtt_step(ctx, "unsubscribe", r, w, _mqtt(
        10, 2, (40).to_bytes(2, "big") + _utf8("plant/a")))
    await _mqtt_step(ctx, "ping", r, w, PINGREQ)
    await ctx.eof("close", r, w)


async def mqtt_over_quota(ctx):
    peer_r, peer_w = await ctx.tcp()
    await _mqtt_step(ctx, "peer.connect", peer_r, peer_w, _connect("dev-2"))
    await _mqtt_step(ctx, "peer.subscribe", peer_r, peer_w,
                     _subscribe("plant/#"))
    r, w = await ctx.tcp()
    await _mqtt_step(ctx, "connect", r, w, _connect("dev-1"))
    # admitted: fanned out to the peer
    await _mqtt_step(ctx, "admitted", r, w,
                     _publish("plant/a", SMALL, qos=1, packet_id=1))
    # over quota: PUBACK all the same (transport acceptance), no ingest,
    # no fan-out, no retain
    await _mqtt_step(ctx, "refused", r, w, _publish(
        "plant/a", P0, qos=1, packet_id=2))
    await _mqtt_step(ctx, "refused-retained", r, w, _mqtt(
        3, 0x01, _utf8("plant/b") + P1), 0)
    await _mqtt_step(ctx, "ping", r, w, PINGREQ)
    # the peer got the admitted publish, then its own PINGRESP: nothing
    # of the refused ones
    await _mqtt_step(ctx, "peer.ping", peer_r, peer_w, PINGREQ, 2)
    await ctx.eof("close", r, w)
    await ctx.eof("peer.close", peer_r, peer_w)


async def mqtt_downlink(ctx):
    listener = ctx.receiver.listener
    r, w = await ctx.tcp()
    await _mqtt_step(ctx, "connect", r, w, _connect("dev-1"))
    await _mqtt_step(ctx, "subscribe", r, w,
                     _subscribe("swx/commands/dev-1"))
    sent = await _w(listener.publish("swx/commands/dev-1", b"reboot"))
    ctx.rec("fan-out", bytes([sent]))
    ctx.rec("command", await _mqtt_read(r))
    # retained for a device that subscribes later
    await _w(listener.publish("swx/commands/dev-2", b"config", retain=True))
    r2, w2 = await ctx.tcp()
    await _mqtt_step(ctx, "late.connect", r2, w2, _connect("dev-2"))
    await _mqtt_step(ctx, "late.subscribe", r2, w2,
                     _subscribe("swx/commands/dev-2"), 2)
    await _mqtt_step(ctx, "ping", r, w, PINGREQ)
    await ctx.eof("close", r, w)
    await ctx.eof("late.close", r2, w2)


def _mutations(rng, valid: bytes, n: int) -> list[bytes]:
    """Seeded hostile inputs from one valid byte stream: random garbage,
    truncations, byte flips and inserted junk."""
    out = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            out.append(bytes(rng.integers(0, 256, int(rng.integers(1, 96)),
                                          dtype=np.uint8)))
        elif kind == 1:
            out.append(valid[:int(rng.integers(1, len(valid)))])
        elif kind == 2:
            b = bytearray(valid)
            for pos in rng.integers(0, len(b), int(rng.integers(1, 5))):
                b[pos] = int(rng.integers(0, 256))
            out.append(bytes(b))
        else:
            pos = int(rng.integers(0, len(valid)))
            junk = bytes(rng.integers(0, 256, int(rng.integers(1, 16)),
                                      dtype=np.uint8))
            out.append(valid[:pos] + junk + valid[pos:])
    return out


async def _fuzz_tcp(ctx, frames, prefix=b"", preamble=None):
    """One connection a frame: the preamble (a handshake), the frame,
    half-close, and whatever the endpoint answers until it hangs up."""
    for i, frame in enumerate(frames):
        r, w = await ctx.tcp()
        if preamble is not None:
            await preamble(ctx, r, w, f"fuzz{i}")
        w.write(prefix + frame)
        await ctx.eof(f"fuzz{i}", r, w)


async def mqtt_fuzz(ctx):
    rng = np.random.default_rng(11)
    valid = (_connect("fz") + _publish("telemetry/fz", SMALL, qos=1)
             + _subscribe("swx/commands/fz") + PINGREQ
             + _publish("telemetry/fz", SMALL, qos=2, packet_id=4))
    await _fuzz_tcp(ctx, _mutations(rng, valid, FUZZ_FRAMES))
    r, w = await ctx.tcp()
    await _mqtt_step(ctx, "after.connect", r, w, _connect("after"))
    await _mqtt_step(ctx, "after.qos1", r, w,
                     _publish("telemetry/after", P0, qos=1, packet_id=2))
    await ctx.eof("after.close", r, w)


# -- WebSocket (RFC 6455) -------------------------------------------------------

WS_KEY = base64.b64encode(bytes(range(16))).decode()
WS_MASK = b"\x11\x22\x33\x44"


def _ws_frame(payload: bytes, opcode: int = 0x2, fin: bool = True,
              mask: bytes = WS_MASK) -> bytes:
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    if n < 126:
        head.append(0x80 | n)
    elif n < 65536:
        head += bytes([0x80 | 126]) + n.to_bytes(2, "big")
    else:
        head += bytes([0x80 | 127]) + n.to_bytes(8, "big")
    return bytes(head) + mask + bytes(
        c ^ mask[i % 4] for i, c in enumerate(payload))


def _upgrade(path: str, headers: str = "", upgrade: bool = True) -> bytes:
    return (f"GET {path} HTTP/1.1\r\nHost: x\r\n"
            + ("Upgrade: websocket\r\n" if upgrade else "")
            + f"Connection: Upgrade\r\nSec-WebSocket-Key: {WS_KEY}\r\n"
            f"Sec-WebSocket-Version: 13\r\n{headers}\r\n").encode()


async def _ws_read(reader) -> bytes:
    head = await _w(reader.readexactly(2))
    n = head[1] & 0x7F
    ext = b""
    if n == 126:
        ext = await _w(reader.readexactly(2))
        n = int.from_bytes(ext, "big")
    return head + ext + (await _w(reader.readexactly(n)) if n else b"")


async def _ws_open(ctx, label, path="/ws/gw-0", headers=""):
    r, w = await ctx.tcp()
    w.write(_upgrade(path, headers))
    ctx.rec(label, await _w(r.readuntil(b"\r\n\r\n")))
    return r, w


async def _ws_step(ctx, label, reader, writer, data, answers=1):
    writer.write(data)
    await _w(writer.drain())
    for i in range(answers):
        ctx.rec(f"{label}.{i}", await _ws_read(reader))


WS_PING = _ws_frame(b"sync", opcode=0x9)


async def ws_messages(ctx):
    r, w = await _ws_open(ctx, "upgrade")
    await _ws_step(ctx, "binary", r, w, _ws_frame(P0), 0)
    third = len(P1) // 3
    await _ws_step(ctx, "fragmented", r, w,
                   _ws_frame(P1[:third], fin=False)
                   + _ws_frame(b"pong", opcode=0xA)
                   + _ws_frame(P1[third:2 * third], opcode=0x0, fin=False)
                   + _ws_frame(P1[2 * third:], opcode=0x0), 0)
    await _ws_step(ctx, "text", r, w, _ws_frame(GARBAGE, opcode=0x1), 0)
    await _ws_step(ctx, "ping", r, w, WS_PING)
    await _ws_step(ctx, "close", r, w,
                   _ws_frame((1000).to_bytes(2, "big"), opcode=0x8))
    await ctx.eof("eof", r, w)


async def ws_tokens(ctx):
    for label, path, headers in (
            ("none", "/ws/gw-0", ""),
            ("wrong", "/ws/gw-0", "Authorization: Bearer nope\r\n"),
            ("other-id", "/ws/gw-1", "Authorization: Bearer tok0\r\n")):
        r, w = await ctx.tcp()
        w.write(_upgrade(path, headers))
        await ctx.eof(label, r, w)
    r, w = await ctx.tcp()
    w.write(_upgrade("/ws/gw-0", upgrade=False))
    await ctx.eof("no-upgrade", r, w)
    r, w = await _ws_open(ctx, "query", "/ws/gw-0?token=tok0")
    await _ws_step(ctx, "binary", r, w, _ws_frame(P0), 0)
    r2, w2 = await _ws_open(ctx, "bearer", "/ws/gw-1",
                            "Authorization: Bearer tok1\r\n")
    await _ws_step(ctx, "binary1", r2, w2, _ws_frame(P1), 0)
    await _ws_step(ctx, "ping1", r2, w2, WS_PING)
    await _ws_step(ctx, "ping", r, w, WS_PING)
    await ctx.eof("close", r, w)
    await ctx.eof("close1", r2, w2)


async def ws_over_quota(ctx):
    r, w = await _ws_open(ctx, "upgrade")
    await _ws_step(ctx, "admitted", r, w, _ws_frame(SMALL), 0)
    await _ws_step(ctx, "ping", r, w, WS_PING)
    # over quota: close 1013 "try again later", connection ends
    await _ws_step(ctx, "refused", r, w, _ws_frame(P0))
    await ctx.eof("eof", r, w)


async def ws_downlink(ctx):
    listener = ctx.receiver.listener
    r, w = await _ws_open(ctx, "upgrade", "/ws/dev-7")
    await _ws_step(ctx, "ping", r, w, WS_PING)
    ctx.rec("sent", bytes([await _w(listener.send("dev-7", b"reboot")),
                           await _w(listener.send("dev-8", b"nobody"))]))
    ctx.rec("command", await _ws_read(r))
    # a second session under the same id replaces the first
    r2, w2 = await _ws_open(ctx, "takeover", "/ws/dev-7")
    await ctx.eof("replaced", r, w)
    ctx.rec("sent2", bytes([await _w(listener.send("dev-7", b"again"))]))
    ctx.rec("command2", await _ws_read(r2))
    await ctx.eof("close", r2, w2)


def _ws_mutations(rng) -> list[bytes]:
    """The hostile frames of tests/test_protocol_fuzz.py, masks fixed."""
    data = bytes(rng.integers(0, 256, int(rng.integers(0, 64)),
                              dtype=np.uint8))
    rsv = bytearray(_ws_frame(b"x"))
    rsv[0] |= 0x40
    unmasked = bytearray(_ws_frame(b"y"))
    unmasked[1] &= 0x7F
    return [
        bytes(rsv), bytes(unmasked),
        _ws_frame(data, opcode=0x3), _ws_frame(data, opcode=0xF),
        _ws_frame(b"ping", opcode=0x9, fin=False),
        _ws_frame(b"p" * 200, opcode=0x9),
        _ws_frame(data, opcode=0x0),
        _ws_frame(b"part", fin=False) + _ws_frame(b"new"),
        bytes([0x82, 0xFF]) + (1 << 60).to_bytes(8, "big") + bytes(4)
        + b"tiny",
        bytes(rng.integers(0, 256, int(rng.integers(2, 64)),
                           dtype=np.uint8)),
    ]


async def ws_fuzz(ctx):
    rng = np.random.default_rng(12)
    frames = []
    while len(frames) < FUZZ_FRAMES:
        muts = _ws_mutations(rng)
        rng.shuffle(muts)
        frames += muts
    frames = frames[:FUZZ_FRAMES // 2] + _mutations(
        rng, _ws_frame(SMALL) + WS_PING, FUZZ_FRAMES - FUZZ_FRAMES // 2)

    async def handshake(ctx, r, w, label):
        w.write(_upgrade(f"/ws/{label}"))
        ctx.rec(label + ".upgrade", await _w(r.readuntil(b"\r\n\r\n")))

    await _fuzz_tcp(ctx, frames, preamble=handshake)
    r, w = await _ws_open(ctx, "after")
    await _ws_step(ctx, "after.binary", r, w, _ws_frame(P0), 0)
    await _ws_step(ctx, "after.ping", r, w, WS_PING)
    await ctx.eof("after.close", r, w)


# -- CoAP (RFC 7252) ------------------------------------------------------------

def _coap_option(delta: int, value: bytes) -> bytes:
    def nib(v):
        if v < 13:
            return v, b""
        if v < 269:
            return 13, bytes([v - 13])
        return 14, (v - 269).to_bytes(2, "big")

    dn, dx = nib(delta)
    ln, lx = nib(len(value))
    return bytes([(dn << 4) | ln]) + dx + lx + value


def _coap(mid: int, payload: bytes = b"", path: str = "telemetry",
          code: int = 0x02, mtype: int = 0, token: bytes = b"\x42",
          query=None) -> bytes:
    out = bytearray([(1 << 6) | (mtype << 4) | len(token), code])
    out += mid.to_bytes(2, "big") + token
    number = 0
    for seg in path.split("/"):
        out += _coap_option(11 - number, seg.encode())
        number = 11
    if query is not None:
        out += _coap_option(15 - number, query.encode())
    if payload:
        out += b"\xff" + payload
    return bytes(out)


class _Udp(asyncio.DatagramProtocol):
    def __init__(self):
        self.replies: asyncio.Queue = asyncio.Queue()

    def datagram_received(self, data, addr):
        self.replies.put_nowait(data)


async def _udp(ctx):
    transport, proto = await _w(asyncio.get_running_loop()
                                .create_datagram_endpoint(
                                    _Udp, remote_addr=("127.0.0.1",
                                                       ctx.port)))
    host, port = transport.get_extra_info("sockname")[:2]
    ctx.aliases[f"{host}:{port}"] = "client"
    return transport, proto


async def _coap_step(ctx, label, transport, proto, data, answers=1):
    transport.sendto(data)
    for i in range(answers):
        ctx.rec(f"{label}.{i}", await _w(proto.replies.get()))


async def _coap_settle(ctx):
    """The listener decodes each accepted POST in a task of its own."""
    tasks = list(ctx.receiver.listener._tasks)
    if tasks:
        await _w(asyncio.gather(*tasks))


async def coap_exchanges(ctx):
    t, p = await _udp(ctx)
    await _coap_step(ctx, "con", t, p, _coap(1, P0))
    # a retransmit (the ACK was lost): the same ACK, not ingested again
    await _coap_step(ctx, "retransmit", t, p, _coap(1, P0))
    await _coap_step(ctx, "non", t, p, _coap(2, P1, mtype=1), 0)
    await _coap_step(ctx, "garbage", t, p, _coap(3, GARBAGE, token=b"ab"))
    await _coap_step(ctx, "get", t, p, _coap(4, code=0x01))
    await _coap_step(ctx, "not-found", t, p, _coap(5, P0, path="other/x"))
    await _coap_step(ctx, "empty", t, p, _coap(6))
    await _coap_step(ctx, "malformed", t, p, bytes([0x49, 0x02, 0, 7]))
    await _coap_step(ctx, "ack", t, p, _coap(8, mtype=2, code=0), 0)
    await _coap_step(ctx, "last", t, p, _coap(9, P2, token=b""))
    await _coap_settle(ctx)
    t.close()


async def coap_secret(ctx):
    t, p = await _udp(ctx)
    await _coap_step(ctx, "none", t, p, _coap(1, P0))
    await _coap_step(ctx, "wrong", t, p, _coap(2, P0, query="token=nope"))
    await _coap_step(ctx, "other", t, p, _coap(3, P0, query="x=s3cret"))
    await _coap_step(ctx, "right", t, p, _coap(4, P0, query="token=s3cret"))
    await _coap_step(ctx, "right-non", t, p,
                     _coap(5, P1, mtype=1, query="token=s3cret"), 0)
    await _coap_step(ctx, "retry-wrong", t, p, _coap(2, P0,
                                                     query="token=s3cret"))
    await _coap_step(ctx, "last", t, p, _coap(6, SMALL, query="token=s3cret"))
    await _coap_settle(ctx)
    t.close()


async def coap_over_quota(ctx):
    t, p = await _udp(ctx)
    await _coap_step(ctx, "admitted", t, p, _coap(1, SMALL))
    # 4.29 Too Many Requests with Max-Age as the retry hint
    await _coap_step(ctx, "refused", t, p, _coap(2, P0))
    await _coap_step(ctx, "refused-retransmit", t, p, _coap(2, P0))
    await _coap_step(ctx, "refused-non", t, p, _coap(3, P1, mtype=1), 0)
    await _coap_step(ctx, "refused-again", t, p, _coap(4, P1))
    await _coap_settle(ctx)
    t.close()


async def coap_fuzz(ctx):
    """The listener reads one datagram a loop turn, so a burst of NON
    datagrams overflows its socket buffer and is dropped; a CON sync
    every 10 datagrams keeps the exchange lossless, and every reply to
    the fuzz comes before the sync's own."""
    rng = np.random.default_rng(13)
    t, p = await _udp(ctx)
    valid = _coap(1, SMALL, token=b"fz")
    frames = _mutations(rng, valid, FUZZ_FRAMES)
    for k in range(0, FUZZ_FRAMES + 1, 10):
        for dgram in frames[k:k + 10]:
            t.sendto(dgram)
        sync = 0xF000 + k
        t.sendto(_coap(sync, P0 if k == FUZZ_FRAMES else b"",
                       code=0x02 if k == FUZZ_FRAMES else 0x01,
                       token=b"end"))
        while True:
            reply = await _w(p.replies.get())
            ctx.rec(f"reply{k}", reply)
            if reply[2:4] == sync.to_bytes(2, "big"):
                break
    await _coap_settle(ctx)
    t.close()


# -- AMQP 0-9-1 -------------------------------------------------------------------

def _amqp_frame(ftype: int, channel: int, payload: bytes) -> bytes:
    return struct.pack(">BHI", ftype, channel, len(payload)) + payload \
        + b"\xce"


def _amqp_method(class_id: int, method_id: int, args: bytes = b"") -> bytes:
    return struct.pack(">HH", class_id, method_id) + args


def _ss(s: str) -> bytes:
    return bytes([len(s.encode())]) + s.encode()


def _ls(b: bytes) -> bytes:
    return struct.pack(">I", len(b)) + b


AMQP_HEADER = b"AMQP\x00\x00\x09\x01"


def _start_ok(user: str, password: str) -> bytes:
    return _amqp_frame(1, 0, _amqp_method(
        10, 11, struct.pack(">I", 0) + _ss("PLAIN")
        + _ls(b"\x00" + user.encode() + b"\x00" + password.encode())
        + _ss("en_US")))


TUNE_OK = _amqp_frame(1, 0, _amqp_method(10, 31,
                                         struct.pack(">HIH", 0, 131072, 0)))
OPEN = _amqp_frame(1, 0, _amqp_method(10, 40, _ss("/") + _ss("") + b"\x00"))
CHANNEL_OPEN = _amqp_frame(1, 1, _amqp_method(20, 10, _ss("")))
CHANNEL_CLOSE_OK = _amqp_frame(1, 1, _amqp_method(20, 41))
CONFIRM_SELECT = _amqp_frame(1, 1, _amqp_method(85, 10, b"\x00"))
CONNECTION_CLOSE = _amqp_frame(1, 0, _amqp_method(
    10, 50, struct.pack(">H", 200) + _ss("bye") + struct.pack(">HH", 0, 0)))


def _amqp_publish(routing_key: str, body: bytes, split: int = 1) -> bytes:
    publish = _amqp_method(60, 40, struct.pack(">H", 0) + _ss("")
                           + _ss(routing_key) + b"\x00")
    header = struct.pack(">HHQH", 60, 0, len(body), 0)
    step = -(-len(body) // split) if body else 1
    return (_amqp_frame(1, 1, publish) + _amqp_frame(2, 1, header)
            + b"".join(_amqp_frame(3, 1, body[i:i + step])
                       for i in range(0, len(body), step)))


async def _amqp_read(reader) -> bytes:
    head = await _w(reader.readexactly(7))
    size = struct.unpack(">I", head[3:7])[0]
    return head + await _w(reader.readexactly(size + 1))


async def _amqp_step(ctx, label, reader, writer, data, answers=1):
    writer.write(data)
    await _w(writer.drain())
    for i in range(answers):
        ctx.rec(f"{label}.{i}", await _amqp_read(reader))


async def _amqp_open(ctx, label, user="gw", password="pw"):
    r, w = await ctx.tcp()
    await _amqp_step(ctx, f"{label}.start", r, w, AMQP_HEADER)
    await _amqp_step(ctx, f"{label}.tune", r, w, _start_ok(user, password))
    await _amqp_step(ctx, f"{label}.open", r, w, TUNE_OK + OPEN)
    await _amqp_step(ctx, f"{label}.channel", r, w, CHANNEL_OPEN)
    return r, w


async def _amqp_close(ctx, r, w):
    await _amqp_step(ctx, "connection.close", r, w, CONNECTION_CLOSE)
    await ctx.eof("eof", r, w)


async def amqp_confirms(ctx):
    r, w = await _amqp_open(ctx, "c")
    await _amqp_step(ctx, "declare", r, w, _amqp_frame(1, 1, _amqp_method(
        50, 10, struct.pack(">H", 0) + _ss("telemetry") + b"\x00"
        + struct.pack(">I", 0))))
    await _amqp_step(ctx, "exchange", r, w, _amqp_frame(1, 1, _amqp_method(
        40, 10, struct.pack(">H", 0) + _ss("x") + _ss("topic") + b"\x00"
        + struct.pack(">I", 0))))
    await _amqp_step(ctx, "select", r, w, CONFIRM_SELECT)
    await _amqp_step(ctx, "publish", r, w, _amqp_publish("telemetry.gw-0", P0))
    await _amqp_step(ctx, "multi-frame", r, w,
                     _amqp_publish("telemetry.gw-0", P1, split=3))
    await _amqp_step(ctx, "garbage", r, w,
                     _amqp_publish("telemetry.gw-0", GARBAGE))
    await _amqp_step(ctx, "heartbeat", r, w, _amqp_frame(8, 0, b""))
    await _amqp_close(ctx, r, w)


async def amqp_credentials(ctx):
    r, w = await ctx.tcp()
    await _amqp_step(ctx, "start", r, w, AMQP_HEADER)
    w.write(_start_ok("gw", "nope"))
    await ctx.eof("refused", r, w)
    r, w = await ctx.tcp()
    w.write(b"HTTP/1.1 GET /\r\n")
    await ctx.eof("bad-header", r, w)
    r, w = await _amqp_open(ctx, "right")
    await _amqp_step(ctx, "select", r, w, CONFIRM_SELECT)
    await _amqp_step(ctx, "publish", r, w, _amqp_publish("k", P0))
    await _amqp_close(ctx, r, w)


async def amqp_consume_refused(ctx):
    r, w = await _amqp_open(ctx, "c")
    await _amqp_step(ctx, "consume", r, w, _amqp_frame(1, 1, _amqp_method(
        60, 20, struct.pack(">H", 0) + _ss("q") + _ss("tag") + b"\x00"
        + struct.pack(">I", 0))))
    await _amqp_step(ctx, "reopen", r, w, CHANNEL_OPEN)
    # a method on a channel never opened: channel error 504
    await _amqp_step(ctx, "closed-channel", r, w, _amqp_frame(
        1, 2, _amqp_method(85, 10, b"\x00")))
    await _amqp_step(ctx, "publish", r, w, _amqp_publish("k", P0), 0)
    await _amqp_step(ctx, "select", r, w, CONFIRM_SELECT)
    await _amqp_close(ctx, r, w)


async def amqp_over_quota(ctx):
    r, w = await _amqp_open(ctx, "c")
    await _amqp_step(ctx, "select", r, w, CONFIRM_SELECT)
    await _amqp_step(ctx, "admitted", r, w, _amqp_publish("k", SMALL))
    # over quota: basic.nack, the connection stays up
    await _amqp_step(ctx, "refused", r, w, _amqp_publish("k", P0))
    await _amqp_step(ctx, "refused-again", r, w, _amqp_publish("k", P1))
    await _amqp_close(ctx, r, w)


async def amqp_oversize(ctx):
    ctx.receiver.listener.max_body = len(SMALL) + 8
    r, w = await _amqp_open(ctx, "c")
    # a body over max_body closes the channel (311), its body frames
    # are swallowed, the connection lives on
    await _amqp_step(ctx, "oversize", r, w, _amqp_publish("k", P0, split=2))
    await _amqp_step(ctx, "close-ok", r, w, CHANNEL_CLOSE_OK + CHANNEL_OPEN)
    await _amqp_step(ctx, "select", r, w, CONFIRM_SELECT)
    await _amqp_step(ctx, "small", r, w, _amqp_publish("k", SMALL))
    await _amqp_close(ctx, r, w)


async def amqp_fuzz(ctx):
    rng = np.random.default_rng(14)
    valid = (AMQP_HEADER + _start_ok("gw", "pw") + TUNE_OK + OPEN
             + CHANNEL_OPEN + CONFIRM_SELECT + _amqp_publish("k", SMALL))
    frames = _mutations(rng, valid, FUZZ_FRAMES - FUZZ_FRAMES // 10)
    frames += [AMQP_HEADER + struct.pack(">BHI", 1, 0, 0x7FFFFFFF)] * (
        FUZZ_FRAMES // 10)
    await _fuzz_tcp(ctx, frames)
    r, w = await _amqp_open(ctx, "after")
    await _amqp_step(ctx, "after.select", r, w, CONFIRM_SELECT)
    await _amqp_step(ctx, "after.publish", r, w, _amqp_publish("k", P0))
    await _amqp_close(ctx, r, w)


# -- STOMP 1.2 ----------------------------------------------------------------------

def _stomp(command: str, headers: dict, body: bytes = b"") -> bytes:
    return (command + "\n" + "".join(f"{k}:{v}\n" for k, v in headers.items())
            + "\n").encode() + body + b"\x00"


async def _stomp_read(reader) -> bytes:
    return await _w(reader.readuntil(b"\x00"))


async def _stomp_step(ctx, label, reader, writer, data, answers=1):
    writer.write(data)
    await _w(writer.drain())
    for i in range(answers):
        ctx.rec(f"{label}.{i}", await _stomp_read(reader))


STOMP_CONNECT = _stomp("CONNECT", {"accept-version": "1.2", "host": "swx",
                                   "login": "gw", "passcode": "pw"})


def _send(dest: str, body: bytes, receipt=None, length=True) -> bytes:
    headers = {"destination": dest}
    if length:
        headers["content-length"] = str(len(body))
    if receipt is not None:
        headers["receipt"] = receipt
    return _stomp("SEND", headers, body)


async def stomp_receipts(ctx):
    r, w = await ctx.tcp()
    await _stomp_step(ctx, "connect", r, w, STOMP_CONNECT)
    await _stomp_step(ctx, "send", r, w, _send("telemetry/gw-0", P0, "r1"))
    await _stomp_step(ctx, "no-receipt", r, w,
                      _send("telemetry/gw-0", P1), 0)
    await _stomp_step(ctx, "text", r, w, _send(
        "telemetry/gw-0", GARBAGE, "r\\c2", length=False))
    await _stomp_step(ctx, "subscribe", r, w, _stomp(
        "SUBSCRIBE", {"destination": "/q", "id": "0", "receipt": "r3"}))
    await _stomp_step(ctx, "disconnect", r, w,
                      b"\r\n" + _stomp("DISCONNECT", {"receipt": "r4"}))
    await ctx.eof("eof", r, w)


async def stomp_credentials(ctx):
    r, w = await ctx.tcp()
    w.write(_stomp("CONNECT", {"login": "gw", "passcode": "nope"}))
    await ctx.eof("wrong", r, w)
    r, w = await ctx.tcp()
    w.write(_send("telemetry/x", P0, "r0"))
    await ctx.eof("no-connect", r, w)
    r, w = await ctx.tcp()
    await _stomp_step(ctx, "stomp", r, w, _stomp(
        "STOMP", {"accept-version": "1.2", "login": "gw", "passcode": "pw"}))
    await _stomp_step(ctx, "send", r, w, _send("telemetry/gw-0", P0, "r1"))
    await _stomp_step(ctx, "bogus", r, w, _stomp("BOGUS", {}))
    await ctx.eof("eof", r, w)


async def stomp_over_quota(ctx):
    r, w = await ctx.tcp()
    await _stomp_step(ctx, "connect", r, w, STOMP_CONNECT)
    await _stomp_step(ctx, "admitted", r, w, _send("t/gw-0", SMALL, "r1"))
    # over quota: ERROR naming the receipt, then the server hangs up
    await _stomp_step(ctx, "refused", r, w, _send("t/gw-0", P0, "r2"))
    await ctx.eof("eof", r, w)


def _stomp_mutations(rng) -> list[bytes]:
    """The hostile SEND frames of tests/test_protocol_fuzz.py."""
    body = bytes(rng.integers(0, 256, int(rng.integers(0, 64)),
                              dtype=np.uint8))
    return [
        b"SEND\ndestination:a\\tb\n\nx\x00",
        b"SEND\ndest\\xination:a\n\nx\x00",
        b"SEND\ndestination:trail\\\n\nx\x00",
        b"SEND\n" + b"h:" + b"A" * (16 * 1024) + b"\n\nx\x00",
        b"SEND\n" + b"".join(b"k%d:v\n" % i for i in range(4000)) + b"\nx\x00",
        b"SEND\ndestination:d\ncontent-length:2\n\nlonger-body\x00",
        b"SEND\ndestination:d\ncontent-length:999999999999\n\nx\x00",
        b"SEND\ndestination:d\ncontent-length:NaN\n\nx\x00",
        b"SEND\ndest\x00ination:d\n\nx\x00",
        b"SEND\ndestination:d\x00\n\nx\x00",
        b"SEND\ndestination:d\n\n\x00\x00",
        b"SEND\ndestination:a\\nb\n\nx\x00",
        bytes(rng.integers(0, 256, int(rng.integers(1, 128)),
                           dtype=np.uint8)),
        (b"SEND\ndestination:d\ncontent-length:%d\n\n" % (len(body) + 40))
        + body,
    ]


async def stomp_fuzz(ctx):
    rng = np.random.default_rng(15)
    frames = []
    while len(frames) < FUZZ_FRAMES // 2:
        muts = _stomp_mutations(rng)
        rng.shuffle(muts)
        frames += muts
    frames = frames[:FUZZ_FRAMES // 2] + _mutations(
        rng, _send("t/fz", SMALL, "r9"), FUZZ_FRAMES - FUZZ_FRAMES // 2)

    async def connect(ctx, r, w, label):
        await _stomp_step(ctx, label + ".connect", r, w, STOMP_CONNECT)

    await _fuzz_tcp(ctx, frames, preamble=connect)
    r, w = await ctx.tcp()
    await _stomp_step(ctx, "after.connect", r, w, STOMP_CONNECT)
    await _stomp_step(ctx, "after.send", r, w, _send("t/after", P0, "r1"))
    await ctx.eof("after.eof", r, w)


# -- the cases ------------------------------------------------------------------------

MQTT_USERS = {"users": {"gw": "s3cret"}}
ALLOW_PLANT = {"subscribe_allow": ["plant/"]}
AMQP_USERS = {"users": {"gw": "pw"}}

CASES = {
    ("mqtt", "publish-qos0-qos1"): (mqtt_publish, {}, None),
    ("mqtt", "qos2-dedup"): (mqtt_qos2, {}, None),
    ("mqtt", "bad-credentials"): (mqtt_credentials, MQTT_USERS, None),
    ("mqtt", "subscription-isolation"): (mqtt_subscriptions, ALLOW_PLANT,
                                         None),
    ("mqtt", "over-quota"): (mqtt_over_quota, ALLOW_PLANT, QUOTA),
    ("mqtt", "downlink-retained"): (mqtt_downlink, {}, None),
    ("mqtt", "fuzz"): (mqtt_fuzz, {}, None),
    ("websocket", "binary-fragmented-text"): (ws_messages, {}, None),
    ("websocket", "bad-token"): (ws_tokens, {"tokens": {"gw-0": "tok0",
                                                        "gw-1": "tok1"}},
                                 None),
    ("websocket", "over-quota"): (ws_over_quota, {}, QUOTA),
    ("websocket", "downlink"): (ws_downlink, {}, None),
    ("websocket", "fuzz"): (ws_fuzz, {}, None),
    ("coap", "con-non-retransmit-errors"): (coap_exchanges, {}, None),
    ("coap", "bad-secret"): (coap_secret, {"secret": "s3cret"}, None),
    ("coap", "over-quota"): (coap_over_quota, {}, QUOTA),
    ("coap", "fuzz"): (coap_fuzz, {}, None),
    ("amqp", "confirms"): (amqp_confirms, AMQP_USERS, None),
    ("amqp", "bad-credentials"): (amqp_credentials, AMQP_USERS, None),
    ("amqp", "consume-refused"): (amqp_consume_refused, AMQP_USERS, None),
    ("amqp", "over-quota"): (amqp_over_quota, AMQP_USERS, QUOTA),
    ("amqp", "oversize-body"): (amqp_oversize, AMQP_USERS, None),
    ("amqp", "fuzz"): (amqp_fuzz, AMQP_USERS, None),
    ("stomp", "send-receipts"): (stomp_receipts, AMQP_USERS, None),
    ("stomp", "bad-credentials"): (stomp_credentials, AMQP_USERS, None),
    ("stomp", "over-quota"): (stomp_over_quota, AMQP_USERS, QUOTA),
    ("stomp", "fuzz"): (stomp_fuzz, AMQP_USERS, None),
}

COUNTERS = ("event_sources.quota_rejected", "event_sources.decode_failures",
            "flow.rejected", "flow.admitted")
LISTENER_COUNTERS = ("rejected", "malformed", "over_quota", "accepted",
                     "unauthorized")


def _alias(text: str, aliases: dict) -> str:
    for real, name in aliases.items():
        text = text.replace(real, name)
    return text


def _records(consumer, aliases: dict) -> list:
    out = []
    while True:
        recs = consumer.poll_nowait(max_records=4096)
        if not recs:
            return sorted(out, key=repr)
        for r in recs:
            v = r.value
            if isinstance(v, dict):      # a failed decode
                out.append(("failed", _alias(v["source"], aliases),
                            v["payload"], v["error"]))
            else:
                out.append((type(v).__name__,
                            _alias(v.ctx.source, aliases),
                            v.device_index.tolist(), v.mtype.tolist(),
                            v.value.tolist(), v.ts.tolist()))


async def _drive(pkg, proto: str, case: str) -> dict:
    conversation, cfg, flow = CASES[(proto, case)]
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="protocols", **pkg.settings))
    rt.add_service(pkg.services.EventSourcesService(rt))
    await _w(rt.start(), 30.0)
    try:
        sections = {"event-sources": {"receivers": [
            {"kind": proto, "decoder": "swb1", "name": "r", **cfg}]}}
        if flow is not None:
            sections["flow"] = flow
        await _w(rt.add_tenant(pkg.config.TenantConfig(
            tenant_id="acme", sections=sections)), 30.0)
        receiver = rt.api("event-sources").engine("acme").receiver("r")
        ctx = Ctx(receiver)
        await _w(conversation(ctx), 60.0)
        naming = pkg.bus.TopicNaming
        topics = [rt.naming.tenant_topic("acme", t) for t in (
            naming.EVENT_SOURCE_DECODED, naming.EVENT_SOURCE_FAILED)]
        consumer = rt.bus.subscribe(topics, group="parity")
        snap = rt.metrics.snapshot()
        listener = receiver.listener
        return {
            "answers": ctx.log,
            "records": _records(consumer, ctx.aliases),
            "counters": {k: snap.get(k) for k in COUNTERS},
            "listener": {k: getattr(listener, k, None)
                         for k in LISTENER_COUNTERS},
        }
    finally:
        await _w(rt.stop(), 30.0)


@pytest.mark.parametrize("proto,case", list(CASES),
                         ids=[f"{p}-{c}" for p, c in CASES])
def test_receiver_matches_the_reference_on_the_wire(run, proto, case):
    want = run(_drive(JAX, proto, case))
    got = run(_drive(PORT, proto, case))
    assert len(got["answers"]) == len(want["answers"])
    for (gl, gb), (wl, wb) in zip(got["answers"], want["answers"]):
        assert gl == wl and gb == wb, (gl, gb[:80], wb[:80])
    assert got["records"] == want["records"]
    assert got["counters"] == want["counters"]
    assert got["listener"] == want["listener"]
    # the conversation did what it was written to do
    assert want["answers"]
    if case not in ("subscription-isolation", "downlink",
                    "downlink-retained"):
        assert any(r[0] == "MeasurementBatch" for r in want["records"])
    if case == "over-quota":
        assert want["counters"]["event_sources.quota_rejected"] >= 1
