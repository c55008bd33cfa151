"""The port's wire bus and API plane (`sitewhere_tpu_torch/kernel/wire.py`)
held to the JAX package's.

The cases of `tests/test_wire.py` and `tests/test_wire_prefetch.py` run
against the port: produce/poll/commit/rebalance over a real socket, the
pinned commit positions, epoch fencing, the shared-secret handshake, the
prefetch credit window, a kill mid-window, revoke on rebalance, seek to
the beginning, per-tick coalescing, the fire-and-forget in-flight cap,
ordering against awaited frames, zero-copy delivery and the push loop's
supervision. Then the two packages talk to each other: a JAX broker
serving a port client and a port broker serving a JAX client run one
scripted conversation and must give the same records, offsets and
commit positions as the JAX pair, with every client writing the same
bytes; a port `ApiChannel` calls a JAX `ApiServer` and the reverse. The
fleet re-runs of `tests/test_wire_prefetch.py` run on the port's fleet
harness (`tests/test_torch_fleet.py`): the kill drill with a credit
window mid-flight, a straddling handoff landing exactly once, and equal
scored output with prefetch on and off. Every wait has its own deadline.
"""

import asyncio
import logging
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu import services as jservices
from sitewhere_tpu.domain import model as jmodel
from sitewhere_tpu.kernel import bus as jbus
from sitewhere_tpu.kernel import service as jservice
from sitewhere_tpu.kernel import wire as jwire
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch import services as tservices
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.domain import model as tmodel
from sitewhere_tpu_torch.kernel import bus as tbus
from sitewhere_tpu_torch.kernel import service as tservice
from sitewhere_tpu_torch.kernel import wire as twire
from sitewhere_tpu_torch.kernel.bus import EventBus, FencedError
from sitewhere_tpu_torch.kernel.wire import (
    ApiServer,
    BusServer,
    RemoteEventBus,
    WireClient,
)
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from tests.test_torch_fleet import DEVICES, _crash, _Meter, fleet

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(bus=jbus, wire=jwire, config=jconfig, model=jmodel,
                      service=jservice, services=jservices)
PORT = SimpleNamespace(bus=tbus, wire=twire, config=tconfig, model=tmodel,
                       service=tservice, services=tservices)


async def wait_until(predicate, timeout=10.0, interval=0.02):
    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError("condition not met")
        await asyncio.sleep(interval)


async def poll_n(consumer, n, max_records=64, timeout=10.0):
    """Poll until `n` records arrived (each poll and the whole wait
    bounded)."""
    got = []
    deadline = asyncio.get_running_loop().time() + timeout
    while len(got) < n:
        assert asyncio.get_running_loop().time() < deadline, (
            f"{len(got)} of {n} records in {timeout} s")
        got += await consumer.poll(max_records=max_records, timeout=1.0)
    return got


# -- the data plane ----------------------------------------------------------


def test_wire_bus_produce_poll_commit_rebalance(run):
    async def main():
        bus = EventBus(default_partitions=4)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port)
        await remote.initialize()
        for i in range(10):
            await remote.produce("t", {"i": i}, key=f"k{i % 3}")
        c_remote = remote.subscribe("t", group="g")
        records = await poll_n(c_remote, 10, max_records=100)
        assert sorted(r.value["i"] for r in records) == list(range(10))
        c_remote.commit()
        await asyncio.sleep(0.05)  # commit is fire-and-forget
        # committed offsets persist across a remote consumer restart
        c_remote.close()
        await asyncio.sleep(0.05)
        await remote.produce("t", {"i": 99})
        c2 = remote.subscribe("t", group="g")
        records = await poll_n(c2, 1, max_records=100)
        assert [r.value["i"] for r in records] == [99]

        # long-poll wakes on produce (not timeout)
        async def later():
            await asyncio.sleep(0.05)
            await remote.produce("t", {"i": 100})

        t = asyncio.get_running_loop().create_task(later())
        t0 = asyncio.get_running_loop().time()
        records = await c2.poll(max_records=10, timeout=5.0)
        waited = asyncio.get_running_loop().time() - t0
        await t
        assert [r.value["i"] for r in records] == [100]
        assert waited < 1.0
        # a dropped connection closes its consumers (group rebalance)
        group = bus._groups["g"]
        assert len(group.members) == 1
        remote._client.close()
        await wait_until(lambda: len(group.members) == 0, timeout=5.0)
        await server.stop()

    run(main())


def test_wire_commit_pins_delivered_positions(run):
    """A bare commit() covers exactly the records delivered to this
    process, never the broker-side consumer's positions (the next poll
    request overtakes the fire-and-forget commit on the wire)."""

    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port)
        await remote.initialize()
        await remote.produce("t", {"i": 0})
        await remote.produce("t", {"i": 1})
        consumer = remote.subscribe("t", group="g")
        first = await consumer.poll(max_records=1, timeout=2.0)
        assert [r.value["i"] for r in first] == [0]
        consumer.commit()
        second = await consumer.poll(max_records=1, timeout=2.0)
        assert [r.value["i"] for r in second] == [1]
        await asyncio.sleep(0.1)  # the commit lands after the poll
        consumer.close()
        await asyncio.sleep(0.05)
        successor = remote.subscribe("t", group="g")
        redelivered = await successor.poll(max_records=10, timeout=2.0)
        assert [r.value["i"] for r in redelivered] == [1], (
            "commit covered an undelivered in-flight batch")
        successor.close()
        await remote.stop()
        await server.stop()

    run(main())


def test_wire_fencing_produce_and_commit(run):
    """A stale-epoch produce raises FencedError with its tenant; a stale
    fire-and-forget commit leaves the group's offsets and reaches
    `on_fenced`."""

    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port)
        await remote.initialize()
        fenced = []
        remote.on_fenced = lambda tenant, epoch: fenced.append((tenant, epoch))
        ctl = "wx.instance.fleet-control"
        topic = "wx.tenant.t0.inbound-events"
        await remote.produce(ctl, {"kind": "placement", "epoch": 1,
                                   "assignment": {"t0": "w0"},
                                   "workers": ["w0", "w1"]})
        await remote.produce(topic, {"n": 1}, fence=["t0", 1, "w0"])
        await remote.produce(ctl, {"kind": "placement", "epoch": 2,
                                   "assignment": {"t0": "w1"},
                                   "workers": ["w1"]})
        with pytest.raises(FencedError) as exc:
            await remote.produce(topic, {"n": 2}, fence=["t0", 1, "w0"])
        assert exc.value.tenant == "t0"
        await remote.produce(topic, {"n": 3}, fence=["t0", 2, "w1"])
        consumer = remote.subscribe(topic, group="t0.inbound-processing")
        assert len(await poll_n(consumer, 2, max_records=10)) == 2
        consumer.commit(fence=["t0", 1, "w0"])
        await wait_until(lambda: fenced, timeout=5.0)
        assert fenced == [("t0", 1)]
        assert not bus._groups["t0.inbound-processing"].committed
        consumer.commit(fence=["t0", 2, "w1"])
        await wait_until(
            lambda: bus._groups["t0.inbound-processing"].committed,
            timeout=5.0)
        assert bus.fences.rejections >= 2
        consumer.close()
        await remote.stop()
        await server.stop()

    run(main())


def test_wire_shared_secret_auth(run):
    async def main():
        backing = EventBus(default_partitions=2)
        await backing.initialize()
        await backing.start()
        server = BusServer(backing, secret="s3cret")
        await server.start()
        try:
            remote = RemoteEventBus("127.0.0.1", server.port, secret="s3cret")
            await remote.initialize()
            await remote.produce("t", {"x": 1}, key="k")
            c = remote.subscribe("t", group="g")
            records = await poll_n(c, 1, max_records=10)
            assert [r.value for r in records] == [{"x": 1}]
            await remote.stop()
            bad = WireClient("127.0.0.1", server.port, secret="nope")
            with pytest.raises((RuntimeError, ConnectionError)):
                await asyncio.wait_for(bad.connect(), 10.0)
            bad.close()
            anon = WireClient("127.0.0.1", server.port)
            await asyncio.wait_for(anon.connect(), 10.0)
            with pytest.raises((RuntimeError, ConnectionError)):
                await asyncio.wait_for(anon.call("topic_names"), 5.0)
            anon.close()
        finally:
            await server.stop()
            await backing.stop()

    run(main())


# -- prefetch: the streaming poll path ---------------------------------------


def test_prefetch_streams_without_poll_rpcs(run):
    async def main():
        bus = EventBus(default_partitions=2)
        server = BusServer(bus)
        polls = 0
        orig = server._op_poll

        async def counting_poll(msg, writer=None):
            nonlocal polls
            polls += 1
            return await orig(msg, writer)

        server.handlers["poll"] = counting_poll
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, prefetch=True,
                                prefetch_credit=32)
        await remote.initialize()
        consumer = remote.subscribe("t", group="g")
        for i in range(20):
            await remote.produce("t", {"i": i}, key=f"k{i % 3}")
        got = [r.value["i"] for r in await poll_n(consumer, 20, max_records=8)]
        assert sorted(got) == list(range(20))
        assert polls == 0, "prefetch mode still issued poll RPCs"

        async def later():
            await asyncio.sleep(0.05)
            await remote.produce("t", {"i": 99})

        t = asyncio.get_running_loop().create_task(later())
        t0 = asyncio.get_running_loop().time()
        records = await consumer.poll(max_records=10, timeout=5.0)
        waited = asyncio.get_running_loop().time() - t0
        await t
        assert [r.value["i"] for r in records] == [99]
        assert waited < 1.0
        consumer.close()
        await remote.stop()
        await server.stop()

    run(main())


def test_prefetch_credit_window_bounds_delivery(run):
    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, prefetch=True,
                                prefetch_credit=8)
        await remote.initialize()
        consumer = remote.subscribe("t", group="g")
        await consumer.poll(max_records=1, timeout=0.2)
        for i in range(64):
            await remote.produce("t", {"i": i})
        await asyncio.sleep(0.3)
        assert len(consumer._buf) <= 8, (
            f"broker pushed {len(consumer._buf)} records past an 8-record "
            f"credit window")
        got = [r.value["i"] for r in await poll_n(consumer, 64, max_records=16)]
        assert got == list(range(64))
        consumer.close()
        await remote.stop()
        await server.stop()

    run(main())


def test_prefetch_kill_mid_credit_window_loses_nothing(run):
    """A consumer killed with a full credit window in flight hands its
    successor exactly every record past the last commit."""

    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, prefetch=True,
                                prefetch_credit=16)
        await remote.initialize()
        for i in range(50):
            await remote.produce("t", {"i": i})
        consumer = remote.subscribe("t", group="g")
        drained = []
        deadline = asyncio.get_running_loop().time() + 10.0
        while len(drained) < 20:
            assert asyncio.get_running_loop().time() < deadline
            drained += [r.value["i"] for r in await consumer.poll(
                max_records=min(5, 20 - len(drained)), timeout=2.0)]
        assert drained == list(range(20))
        consumer.commit()
        await asyncio.sleep(0.2)
        remote._client.kill()
        await asyncio.sleep(0.1)
        successor_bus = RemoteEventBus("127.0.0.1", server.port,
                                       prefetch=True, prefetch_credit=16)
        await successor_bus.initialize()
        successor = successor_bus.subscribe("t", group="g")
        redelivered = [r.value["i"] for r in
                       await poll_n(successor, 30, max_records=16)]
        assert redelivered == list(range(20, 50))
        successor.close()
        await successor_bus.stop()
        await server.stop()

    run(main())


def test_prefetch_revoke_on_rebalance_no_double_delivery(run):
    async def main():
        bus = EventBus(default_partitions=4)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, prefetch=True,
                                prefetch_credit=64)
        await remote.initialize()
        c1 = remote.subscribe("t", group="g")
        await c1.poll(max_records=1, timeout=0.2)
        for i in range(40):
            await remote.produce("t", {"i": i}, key=f"k{i}")
        await wait_until(lambda: len(c1._buf) == 40, timeout=10.0)
        c2 = remote.subscribe("t", group="g")
        got1, got2 = [], []
        got2 += [r.value["i"]
                 for r in await c2.poll(max_records=64, timeout=2.0)]
        await wait_until(lambda: len(c1._buf) < 40, timeout=10.0)
        deadline = asyncio.get_running_loop().time() + 10.0
        while (len(got1) + len(got2) < 40
               and asyncio.get_running_loop().time() < deadline):
            got1 += [r.value["i"]
                     for r in await c1.poll(max_records=16, timeout=0.2)]
            got2 += [r.value["i"]
                     for r in await c2.poll(max_records=16, timeout=0.2)]
        assert sorted(got1 + got2) == list(range(40)), (
            f"double/lost delivery across rebalance: {len(got1)}+{len(got2)}")
        c1.close()
        c2.close()
        await remote.stop()
        await server.stop()

    run(main())


def test_prefetch_seek_to_beginning_replays_cleanly(run):
    async def main():
        bus = EventBus(default_partitions=2)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, prefetch=True,
                                prefetch_credit=32)
        await remote.initialize()
        for i in range(10):
            await remote.produce("t", {"i": i}, key=f"k{i}")
        warm = remote.subscribe("t", group="g")
        await poll_n(warm, 10, max_records=16)
        warm.commit()
        await asyncio.sleep(0.2)
        warm.close()
        await asyncio.sleep(0.1)
        replayer = remote.subscribe("t", group="g")
        replayer.seek_to_beginning()
        replayed = [r.value["i"] for r in
                    await poll_n(replayer, 10, max_records=16)]
        assert sorted(replayed) == list(range(10))
        replayer.seek_to_beginning()
        again = [r.value["i"] for r in
                 await poll_n(replayer, 10, max_records=16)]
        assert sorted(again) == list(range(10)), again
        replayer.close()
        await remote.stop()
        await server.stop()

    run(main())


def test_prefetch_delivers_zero_copy_views(run):
    """Delivered batch columns are read-only views over the received
    frame, exact in content."""

    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, prefetch=True,
                                prefetch_credit=8)
        await remote.initialize()
        ctx = tbatch.BatchContext(tenant_id="t", source="s", trace_id=7)
        values = np.linspace(0.0, 1.0, 4096).astype(np.float32)
        batch = tbatch.MeasurementBatch(
            ctx, np.arange(4096, dtype=np.uint32), np.zeros(4096, np.uint16),
            values, np.full(4096, 1700000000.0))
        await remote.produce("t", batch, key="s")
        consumer = remote.subscribe("t", group="g")
        out = (await poll_n(consumer, 1, max_records=4))[0].value
        np.testing.assert_array_equal(out.value, values)
        assert out.ctx.tenant_id == "t" and out.ctx.trace_id == 7
        assert out.value.base is not None
        assert not out.value.flags.writeable
        consumer.close()
        await remote.stop()
        await server.stop()

    run(main())


def test_push_loop_death_is_supervised(run, caplog):
    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)

        async def doomed(cid, consumer, writer, st):
            raise RuntimeError("push loop exploded")

        server._push_loop = doomed
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, prefetch=True,
                                prefetch_credit=8)
        await remote.initialize()
        consumer = remote.subscribe("t", group="g")
        await consumer.poll(max_records=1, timeout=0.3)
        await asyncio.sleep(0.05)
        consumer.close()
        await remote.stop()
        await server.stop()

    with caplog.at_level(logging.ERROR,
                         logger="sitewhere_tpu_torch.kernel.wire"):
        run(main())
    assert any("died unexpectedly" in r.getMessage() for r in caplog.records)


# -- pipelined produce and the fire-and-forget window -------------------------


def test_produce_nowait_coalesces_per_tick(run):
    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        batches = []
        orig = server._op_batch

        async def counting_batch(msg, writer=None):
            batches.append(len(msg["ops"]))
            return await orig(msg, writer)

        server.handlers["batch"] = counting_batch
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port)
        await remote.initialize()
        for i in range(32):
            remote.produce_nowait("t", {"i": i})
        assert len(remote._client._bg) <= 1, "produce_nowait spawned per-op tasks"
        await wait_until(lambda: bus.end_offsets("t") == [32], timeout=5.0)
        assert max(batches) >= 16, f"ops did not coalesce: {batches}"
        assert remote.wire_stats()["frames_coalesced"] >= 16
        await remote.stop()
        await server.stop()

    run(main())


def test_ff_inflight_cap_backpressure_gated_broker(run):
    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        gate = asyncio.Event()
        orig = server._op_batch

        async def gated_batch(msg, writer=None):
            await gate.wait()
            return await orig(msg, writer)

        server.handlers["batch"] = gated_batch
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port, inflight_cap=16)
        await remote.initialize()
        assert remote.backlogged is False
        for i in range(100):
            remote.produce_nowait("t", {"i": i})
            await asyncio.sleep(0)
        client = remote._client
        # the window fills to the cap and no further (a condition, not a
        # fixed sleep: a loaded host may take longer to write the frames)
        await wait_until(lambda: client._ff_inflight == 16, timeout=5.0)
        assert remote.backlogged is True
        assert client._ff_inflight <= 16
        assert len(client._bg) <= 16
        assert client.ff_pending == 100
        gate.set()
        await wait_until(lambda: bus.end_offsets("t") == [100], timeout=10.0)
        await wait_until(lambda: not remote.backlogged, timeout=5.0)
        # the broker appends before it acks: the last frames' acks may
        # still be on their way when the offsets reach the end, so every
        # op being acked (nothing dropped) is waited for, not sampled
        await wait_until(lambda: client.ff_pending == 0, timeout=5.0)
        assert client.ff_pending == 0
        await remote.stop()
        await server.stop()

    run(main())


def test_ff_order_preserved_vs_awaited_frames(run):
    async def main():
        bus = EventBus(default_partitions=1)
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port)
        await remote.initialize()
        remote.produce_nowait("t", {"seq": 0})
        await remote.produce("t", {"seq": 1})
        await wait_until(lambda: bus.end_offsets("t") == [2], timeout=5.0)
        values = [r.value["seq"] for r in bus.peek("t", limit=-1)]
        assert values == [0, 1], values
        await remote.stop()
        await server.stop()

    run(main())


def test_egress_barrier_surfaces_wire_backpressure():
    class _Bus:
        backlogged = True
        produce_nowait = None

    class _Runtime:
        bus = _Bus()

    from sitewhere_tpu_torch.kernel.egresslane import EgressStage

    stage = object.__new__(EgressStage)
    stage.engine = type("E", (), {"runtime": _Runtime()})()
    stage.submitted = 0
    stage.accounted = 0
    stage.active = 1
    assert stage.backlogged is True
    _Bus.backlogged = False
    assert stage.backlogged is False


# ---------------------------------------------------------------------------
# fleet equivalence re-runs over the wire (prefetch on): the cases of
# `tests/test_wire_prefetch.py:395-527` on the port's fleet harness
# ---------------------------------------------------------------------------


def test_fleet_kill_drill_wire_prefetch_zero_loss(run, tmp_path):
    """`tests/test_torch_fleet.py`'s kill drill over a REAL wire broker with
    prefetch on: the victim dies with a credit window mid-flight
    (socket dropped, no final commits) — reassignment converges and
    every accepted event is scored by somebody (zero loss)."""

    async def main():
        async with fleet(tmp_path, n_workers=2, n_tenants=2,
                         wire=True) as (
                driver, controller, runtimes, workers, cfgs):
            meter = _Meter(driver, cfgs)
            for _ in range(3):
                await meter.submit_round()
            await meter.drain_until_caught_up()

            victim = controller.snapshot()["assignment"]["t0"]
            survivor = next(w for w in workers if w != victim)
            # keep accepting through the crash + reassignment window so
            # the killed credit window has live records in it
            await meter.submit_round()
            await _crash(runtimes, workers, victim)
            for _ in range(4):
                await meter.submit_round()
                await asyncio.sleep(0.05)
            await wait_until(
                lambda: victim not in controller.snapshot()["workers"],
                timeout=30.0)
            await wait_until(
                lambda: controller.snapshot()["converged"], timeout=120.0)
            snap = controller.snapshot()
            assert all(w == survivor for w in snap["assignment"].values())
            for _ in range(2):
                await meter.submit_round()
            await meter.drain_until_caught_up(timeout=120.0)
            # zero lost accepted events (at-least-once: >= is the bound
            # a crash permits; the straddle test pins == for the clean
            # handoff)
            for tid in meter.sent:
                assert meter.scored[tid] >= meter.sent[tid], (
                    tid, meter.sent[tid], meter.scored[tid])
            meter.close()

    run(main())


def test_fleet_straddle_exactly_once_wire_prefetch(run, tmp_path):
    """`tests/test_torch_fleet.py`'s straddle invariant over the wire with
    prefetch on: a clean drain-then-handoff migration under continuous
    flood lands every batch EXACTLY once — the loser's delivered-pin
    commit covers only drained records, its undrained prefetch buffer
    is discarded at close, and the adopter resumes from committed."""

    async def main():
        async with fleet(tmp_path, n_workers=2, n_tenants=2,
                         wire=True) as (
                driver, controller, runtimes, workers, cfgs):
            meter = _Meter(driver, cfgs)
            await meter.submit_round()
            await meter.drain_until_caught_up()

            source = controller.snapshot()["assignment"]["t0"]
            target = next(w for w in workers if w != source)
            controller.migrate("t0", target)
            for _ in range(12):
                await meter.submit_round()
                await asyncio.sleep(0.02)
            await wait_until(
                lambda: controller.snapshot()["owners"].get("t0")
                == target and controller.snapshot()["converged"],
                timeout=60.0)
            for _ in range(2):
                await meter.submit_round()
            await meter.drain_until_caught_up(timeout=120.0)
            # exactly once: scored == sent (< is loss, > is duplicate)
            for tid in meter.sent:
                assert meter.scored[tid] == meter.sent[tid], (
                    tid, meter.sent[tid], meter.scored[tid])
            meter.close()

    run(main())


def test_prefetch_on_off_scored_output_equivalence(run, tmp_path):
    """The fast path must not bend a single score: the same simulator
    traffic through a 1-worker wire fleet produces IDENTICAL scored
    tuples with prefetch/pipelining on and off."""

    async def one_leg(leg_dir, fast):
        outputs = []
        async with fleet(leg_dir, n_workers=1, n_tenants=1,
                         wire=True, wire_prefetch=fast,
                         wire_pipeline=fast) as (
                driver, controller, runtimes, workers, cfgs):
            tid = cfgs[0].tenant_id
            consumer = driver.bus.subscribe(
                driver.naming.tenant_topic(tid, "scored-events"),
                group="equiv-meter")
            receiver = driver.api("event-sources").engine(tid) \
                .receiver("default")
            sim = DeviceSimulator(SimConfig(num_devices=DEVICES, seed=11),
                                  tenant_id=tid)
            sent = 0
            for k in range(6):
                if await receiver.submit(sim.payload(t=3000.0 + k)[0]):
                    sent += DEVICES

            def caught_up():
                for record in consumer.poll_nowait(max_records=256):
                    scored = record.value
                    for i in range(len(scored)):
                        outputs.append((
                            int(scored.device_index[i]),
                            round(float(scored.score[i]), 5),
                            bool(scored.is_anomaly[i])))
                return len(outputs) >= sent

            await wait_until(caught_up, timeout=90.0)
            consumer.close()
        return sorted(outputs)

    async def main():
        on = await one_leg(tmp_path / "on", True)
        off = await one_leg(tmp_path / "off", False)
        assert len(on) == len(off) > 0
        assert on == off, "prefetch changed scored output"

    run(main())



async def _cancelled_first_poll(pkg) -> int:
    """A consumer's task is cancelled during its first poll, while the
    broker still holds the subscribe; the consumer is closed, then the
    broker answers. Returns the group's members left on the broker."""
    bus = pkg.bus.EventBus(default_partitions=4)
    server = pkg.wire.BusServer(bus)
    gate = asyncio.Event()
    orig = server.handlers["subscribe"]

    async def gated(msg, writer=None):
        await gate.wait()
        return await orig(msg, writer)

    server.handlers["subscribe"] = gated
    await server.start()
    remote = pkg.wire.RemoteEventBus("127.0.0.1", server.port)
    await remote.initialize()
    consumer = remote.subscribe("t", group="g")
    task = asyncio.get_running_loop().create_task(
        consumer.poll(max_records=8, timeout=1.0))
    await wait_until(lambda: server._conns, timeout=5.0)
    await asyncio.sleep(0.05)  # the subscribe frame is at the broker
    task.cancel()
    with pytest.raises(asyncio.CancelledError):
        await task
    consumer.close()  # an engine's stop: the loop's `finally`
    gate.set()
    await asyncio.sleep(0.3)
    left = len(bus._groups["g"].members) if "g" in bus._groups else 0
    await remote.stop()
    await server.stop()
    return left


def test_subscribe_answered_after_cancellation_leaves_no_member(run):
    """An engine stopped during its consumer's first poll (a tenant
    released while its adopt was still starting) must not leave the
    broker-side member its subscribe creates: that member would hold its
    share of the group's partitions with nobody polling them. The port's
    lazy consumer closes it when the answer lands; the JAX one
    (`sitewhere_tpu/kernel/wire.py` `_LazyRemoteConsumer._ensure`) leaves
    it, which stalled a tenant's group in the fleet (ROADMAP C)."""
    assert run(_cancelled_first_poll(PORT)) == 0
    assert run(_cancelled_first_poll(JAX)) == 1


# -- the API plane ------------------------------------------------------------


def test_api_server_blocks_private_sub_accessor(run):
    async def main():
        class FakeService:
            def api(self):
                return self

            def ping(self):
                return "pong"

        class FakeRuntime:
            services = {"svc": FakeService()}

        server = ApiServer(FakeRuntime(), host="127.0.0.1", port=0)
        assert await server._op_call(
            {"identifier": "svc", "method": "ping"}) == "pong"
        with pytest.raises(PermissionError):
            await server._op_call(
                {"identifier": "svc", "method": "ping", "sub": "_secret"})
        with pytest.raises(PermissionError):
            await server._op_call({"identifier": "svc", "method": "_private"})

    run(main())


async def _dm_runtime(pkg):
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="api-test"))
    rt.add_service(pkg.services.DeviceManagementService(rt))
    await rt.start()
    await rt.add_tenant(pkg.config.TenantConfig(tenant_id="acme"))
    dm = rt.api("device-management").management("acme")
    dm.bootstrap_fleet(pkg.model.DeviceType(token="thermo", name="T"), 10)
    return rt


def _entity(obj) -> dict:
    """An entity's fields but those that differ between two runs (uuids
    and clocks)."""
    return {k: getattr(obj, k) for k in ("token", "index", "status",
                                         "comments", "parent_device_id")}


async def _dm_conversation(server_pkg, client_pkg) -> list:
    """A scripted device-management conversation from `client_pkg`'s
    ApiChannel to `server_pkg`'s ApiServer."""
    rt = await _dm_runtime(server_pkg)
    server = server_pkg.wire.ApiServer(rt)
    await server.start()
    channel = client_pkg.wire.ApiChannel("127.0.0.1", server.port)
    out = []
    try:
        out.append(await asyncio.wait_for(channel.wait_engine(
            "device-management", "acme", timeout=5.0), 10.0))
        mask = await asyncio.wait_for(channel.call(
            "device-management", "registered_mask", tenant="acme",
            args=[np.asarray([0, 5, 42], np.uint32)]), 10.0)
        out.append(mask.tolist())
        device = await asyncio.wait_for(channel.call(
            "device-management", "get_device_by_token", tenant="acme",
            args=["dev-3"]), 10.0)
        assert type(device).__module__.startswith(
            client_pkg.model.__name__.split(".")[0] + ".")
        out.append(_entity(device))
        missing = await asyncio.wait_for(channel.call(
            "device-management", "get_device_by_token", tenant="acme",
            args=["nope"]), 10.0)
        out.append(missing)
        with pytest.raises(RuntimeError, match="not exposed"):
            await asyncio.wait_for(channel.call(
                "device-management", "_do_start", tenant="acme"), 10.0)
        health = await asyncio.wait_for(channel.health(), 10.0)
        out.append(sorted(health))
    finally:
        channel.close()
        await server.stop()
        await rt.stop()
    return out


@pytest.mark.parametrize("pair", ["port-port", "port-client-jax-server",
                                  "jax-client-port-server"])
def test_api_channel_engine_calls(run, pair):
    """wait_engine, engine calls with numpy in and out, a dataclass
    result, a miss, the private-method refusal and health, over the
    wire: every pair answers as the JAX pair does."""
    server, client = {"port-port": (PORT, PORT),
                      "port-client-jax-server": (JAX, PORT),
                      "jax-client-port-server": (PORT, JAX)}[pair]
    want = run(_dm_conversation(JAX, JAX))
    assert want[1] == [True, True, False] and want[2]["token"] == "dev-3"
    assert run(_dm_conversation(server, client)) == want


# -- cross-package pairs on the data plane ------------------------------------


class Recorder:
    """A TCP relay between a client and a broker that keeps every byte
    the client writes."""

    def __init__(self, port):
        self.target, self.sent, self._tasks = port, bytearray(), set()

    async def start(self):
        self._server = await asyncio.start_server(self._handle, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]

    async def _handle(self, reader, writer):
        up_r, up_w = await asyncio.open_connection("127.0.0.1", self.target)

        async def pump(src, dst, keep):
            try:
                while data := await src.read(65536):
                    if keep:
                        self.sent += data
                    dst.write(data)
                    await dst.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                dst.close()

        for t in (pump(reader, up_w, True), pump(up_r, writer, False)):
            task = asyncio.create_task(t)
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def stop(self):
        self._server.close()
        for t in list(self._tasks):
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)


async def _scripted(broker_pkg, client_pkg, prefetch: bool) -> dict:
    """One scripted conversation: keyed produces, fire-and-forget
    produces, a consumer group polling and committing part of the way,
    a successor resuming, a second group seeking to the beginning."""
    backing = broker_pkg.bus.EventBus(default_partitions=3)
    await backing.initialize()
    await backing.start()
    server = broker_pkg.wire.BusServer(backing)
    await server.start()
    relay = Recorder(server.port)
    await relay.start()
    remote = client_pkg.wire.RemoteEventBus("127.0.0.1", relay.port,
                                            prefetch=prefetch,
                                            prefetch_credit=64)
    await remote.initialize()
    rows = lambda recs: [(r.topic, r.partition, r.offset, r.key, r.value)
                         for r in recs]
    out = {}
    try:
        for i in range(12):
            await remote.produce("t", {"i": i, "a": [i, str(i)]},
                                 key=f"k{i % 4}")
        for i in range(12, 16):
            remote.produce_nowait("t", {"i": i}, key=f"k{i % 4}")
        await wait_until(lambda: sum(backing.end_offsets("t")) == 16)
        c = remote.subscribe("t", group="g")
        first = await poll_n(c, 16, max_records=64)
        out["first"] = sorted(rows(first))
        # commit through the last record below i=8 of each partition
        upto = {}
        for r in first:
            if r.value["i"] < 8:
                upto[(r.topic, r.partition)] = r.offset + 1
        c.commit(upto)
        await wait_until(lambda: backing._groups["g"].committed, timeout=5.0)
        await asyncio.sleep(0.1)
        c.close()
        await wait_until(lambda: not backing._groups["g"].members,
                         timeout=5.0)
        c2 = remote.subscribe("t", group="g")
        left = sum(1 for r in first
                   if r.offset >= upto.get((r.topic, r.partition), 0))
        out["resumed"] = sorted(rows(await poll_n(c2, left, max_records=64)))
        c2.close()
        replay = remote.subscribe("t", group="replay")
        replay.seek_to_beginning()
        out["replayed"] = sorted(rows(await poll_n(replay, 16,
                                                   max_records=64)))
        replay.close()
        out["end_offsets"] = await remote.end_offsets("t")
        out["committed"] = sorted(backing._groups["g"].committed.items())
        out["topics"] = sorted(await remote.topic_names())
    finally:
        await remote.stop()
        await relay.stop()
        await server.stop()
        await backing.stop()
    out["bytes"] = bytes(relay.sent)
    return out


@pytest.mark.parametrize("pair", ["jax-broker-port-client",
                                  "port-broker-jax-client"])
@pytest.mark.parametrize("prefetch", [False, True], ids=["poll", "prefetch"])
def test_cross_package_wire_pairs(run, pair, prefetch):
    """The same scripted ops give the same records, offsets and commit
    positions as the JAX pair, and (request/response plane) every
    client writes the same bytes."""
    broker, client = {"jax-broker-port-client": (JAX, PORT),
                      "port-broker-jax-client": (PORT, JAX)}[pair]
    want = run(_scripted(JAX, JAX, prefetch))
    got = run(_scripted(broker, client, prefetch))
    want_bytes, got_bytes = want.pop("bytes"), got.pop("bytes")
    assert len(want["first"]) == 16 and want["committed"]
    assert got == want
    if not prefetch:
        # the push path's credit grants follow the pushes' timing
        assert got_bytes == want_bytes
