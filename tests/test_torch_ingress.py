"""The slice as a whole on the CPU: the scored pipeline fed through the
protocol receivers, the protocol clients, and `cli simulate`.

- The two-package pipeline of tests/test_torch_pipeline.py
  (`lstm-stream` through the pool, 4 tenants × 32 devices × 10 ticks,
  the same weights through `convert.py`), fed through each package's
  mqtt or amqp receiver by that package's own `MqttSender` /
  `AmqpSender` instead of `receiver.submit`: the same scored keys,
  scores within 1e-2 + 1e-3 relative (float16 readback on both sides),
  alerts, totals and committed offsets.
- The port's `sim/clients` senders write the same bytes as the JAX
  package's for the same payloads, captured by a local proxy in front
  of a real listener (WebSocket's random key and masks fixed by
  patching `os.urandom` on both sides).
- `python -m sitewhere_tpu_torch.cli simulate --protocol mqtt` against a
  port runtime on the CPU: it exits 0, and the events it reports sent
  are the events persisted.
"""

import asyncio
import itertools
import os
import re
import sys
from pathlib import Path

import pytest
import torch

from sitewhere_tpu.sim import clients as jclients
from sitewhere_tpu_torch.sim import clients as tclients
from tests.test_pipeline import wait_until
from tests.test_torch_pipeline import (
    JAX_PKG,
    PORT_PKG,
    _drive,
    _weights,
    assert_same_pipeline,
)

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
STEP = 10.0


@pytest.mark.parametrize("protocol", ["mqtt", "amqp"])
def test_pipeline_through_protocol_receivers_matches_jax(run, protocol):
    case = "lstm-stream-pool"
    weights = _weights(case)
    want = run(_drive(JAX_PKG, case, weights, port=False, protocol=protocol))
    got = run(_drive(PORT_PKG, case, weights, port=True, protocol=protocol))
    assert_same_pipeline(case, want, got)


# -- the protocol clients, byte for byte -----------------------------------------

class _Proxy:
    """TCP proxy that records every byte a client sends before passing
    it on to the real listener (and the listener's answers back)."""

    def __init__(self, upstream_port: int):
        self.upstream_port = upstream_port
        self.sent = bytearray()
        self._server = None
        self._tasks: list[asyncio.Task] = []

    async def start(self) -> int:
        self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        return self._server.sockets[0].getsockname()[1]

    async def _pipe(self, reader, writer, record: bool) -> None:
        try:
            while data := await reader.read(65536):
                if record:
                    self.sent += data
                writer.write(data)
                await writer.drain()
        except ConnectionError:
            pass
        finally:
            if writer.can_write_eof():
                try:
                    writer.write_eof()
                except (OSError, RuntimeError):
                    pass

    async def _handle(self, reader, writer) -> None:
        up_r, up_w = await asyncio.open_connection("127.0.0.1",
                                                   self.upstream_port)
        self._tasks += [asyncio.ensure_future(self._pipe(reader, up_w, True)),
                        asyncio.ensure_future(self._pipe(up_r, writer, False))]

    async def stop(self) -> None:
        await asyncio.wait_for(asyncio.gather(*self._tasks), STEP)
        self._server.close()


class _UdpSink(asyncio.DatagramProtocol):
    def __init__(self):
        self.sent = bytearray()
        self.count = 0

    def datagram_received(self, data, addr):
        self.sent += len(data).to_bytes(4, "big") + data
        self.count += 1


async def _listener(protocol: str, got: list):
    """A real listener of the JAX package to talk to (the sink for tcp)."""
    from sitewhere_tpu.services import amqp, mqtt, stomp, websocket

    async def on_message(*args):
        got.append(args)
        return True

    if protocol == "tcp":
        async def sink(reader, writer):
            got.append(await reader.read())
            writer.close()

        server = await asyncio.start_server(sink, "127.0.0.1", 0)
        return server, server.sockets[0].getsockname()[1]
    listener = {"mqtt": mqtt.MqttListener, "websocket":
                websocket.WebSocketListener, "amqp": amqp.AmqpListener,
                "stomp": stomp.StompListener}[protocol](on_message)
    await listener.start()
    return listener, listener.port


SENDER_KW = {"tcp": {}, "coap": {"path": "telemetry/gw-0", "secret": "s"},
             "mqtt": {"topic": "telemetry/gw-0", "client_id": "gw-0",
                      "username": "u", "password": "p"},
             "websocket": {"client_id": "gw-0", "token": "tok"},
             "amqp": {"routing_key": "telemetry.gw-0"},
             "stomp": {"destination": "telemetry/gw-0", "username": "u",
                       "password": "p"}}
# one small payload and one past 65,535 B (the WebSocket 64-bit length)
PAYLOADS = [bytes(range(256)) * 3, b"\x00\x7f" * 40_000, b"x"]


async def _capture(clients, protocol: str) -> bytes:
    got: list = []
    if protocol == "coap":
        transport, sink = await asyncio.get_running_loop() \
            .create_datagram_endpoint(_UdpSink, local_addr=("127.0.0.1", 0))
        port = transport.get_extra_info("sockname")[1]
        sender = clients.make_sender("coap", "127.0.0.1", port,
                                     **SENDER_KW["coap"])
        await asyncio.wait_for(sender.connect(), STEP)
        for payload in PAYLOADS[::2]:
            await sender.send(payload)
        await wait_until(lambda: sink.count == 2, timeout=STEP)
        await sender.close()
        transport.close()
        return bytes(sink.sent)
    server, upstream = await _listener(protocol, got)
    proxy = _Proxy(upstream)
    port = await proxy.start()
    sender = clients.make_sender(protocol, "127.0.0.1", port,
                                 **SENDER_KW[protocol])
    await asyncio.wait_for(sender.connect(), STEP)
    for payload in PAYLOADS:
        await asyncio.wait_for(sender.send(payload), STEP)
    await asyncio.wait_for(sender.close(), STEP)
    await proxy.stop()
    if protocol == "tcp":
        await wait_until(lambda: got, timeout=STEP)
        server.close()
        assert got[0] == b"".join(len(p).to_bytes(4, "little") + p
                                  for p in PAYLOADS)
    else:
        await wait_until(lambda: len(got) == len(PAYLOADS), timeout=STEP)
        await asyncio.wait_for(server.stop(), STEP)
        assert [a[1] if protocol in ("mqtt", "amqp", "stomp") else a[0]
                for a in got] == PAYLOADS
    return bytes(proxy.sent)


@pytest.mark.parametrize("protocol", list(SENDER_KW))
def test_senders_write_the_same_bytes(run, monkeypatch, protocol):
    def fixed_urandom():
        counter = itertools.count()
        return lambda n: bytes((next(counter) * 7 + i) % 256
                               for i in range(n))

    monkeypatch.setattr(os, "urandom", fixed_urandom())
    want = run(_capture(jclients, protocol))
    monkeypatch.setattr(os, "urandom", fixed_urandom())
    got = run(_capture(tclients, protocol))
    assert len(want) > sum(len(p) for p in PAYLOADS[::2])
    assert got == want


# -- cli simulate ---------------------------------------------------------------------

def test_cli_simulate_over_mqtt_persists_what_it_sent(run):
    from sitewhere_tpu_torch.cli import build_runtime
    from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
    from sitewhere_tpu_torch.domain.model import DeviceType

    devices = 64

    async def main():
        rt = build_runtime(InstanceSettings(instance_id="simulate",
                                            device="cpu"))
        await rt.start()
        try:
            await rt.add_tenant(TenantConfig(tenant_id="acme", sections={
                "event-sources": {"receivers": [
                    {"kind": "mqtt", "decoder": "swb1", "name": "mqtt"}]},
                "rule-processing": {"model": "zscore",
                                    "model_config": {"window": 16}}}))
            rt.api("device-management").management("acme").bootstrap_fleet(
                DeviceType(token="thermo", name="T"), devices)
            port = rt.api("event-sources").engine("acme").receiver(
                "mqtt").port
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "sitewhere_tpu_torch.cli", "simulate",
                "--protocol", "mqtt", "--port", str(port), "--devices",
                str(devices), "--seconds", "1", "--rate", "20",
                "--topic", "telemetry/sim", cwd=str(ROOT),
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            out, err = await asyncio.wait_for(proc.communicate(), 120.0)
            assert proc.returncode == 0, err.decode()[-2000:]
            m = re.search(r"sent (\d+) events over mqtt", out.decode())
            assert m, out.decode()
            sent = int(m.group(1))
            assert sent >= devices
            em = rt.api("event-management").management("acme")
            await wait_until(lambda: em.telemetry.total_events >= sent,
                             timeout=30.0)
            await asyncio.sleep(0.1)
            assert em.telemetry.total_events == sent
        finally:
            await rt.stop()

    run(main())
