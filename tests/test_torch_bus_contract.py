"""The bus contract of `tests/test_bus_contract.py` over the port's three
buses: the in-proc `EventBus`, the wire bus (`BusServer` +
`RemoteEventBus` over real sockets) and `KafkaEventBus` on the in-repo
aiokafka fake (`kernel/fake_kafka.py`; neither machine has aiokafka, and
without it `KafkaEventBus` raises as the JAX one does). Per-key
ordering, consumer groups, commit/resume at-least-once and the long-poll
wake hold on each; then the Kafka adapter's retained fire-and-forget
(`_spawn_logged`)."""

import asyncio
import contextlib
import itertools
import logging

import pytest
import torch

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)


@contextlib.asynccontextmanager
async def inproc_bus():
    from sitewhere_tpu_torch.kernel.bus import EventBus

    bus = EventBus(default_partitions=4)
    await bus.initialize()
    await bus.start()
    try:
        yield bus
    finally:
        await bus.stop()


@contextlib.asynccontextmanager
async def wire_bus():
    from sitewhere_tpu_torch.kernel.bus import EventBus
    from sitewhere_tpu_torch.kernel.wire import BusServer, RemoteEventBus

    backing = EventBus(default_partitions=4)
    await backing.initialize()
    await backing.start()
    server = BusServer(backing)
    await server.start()
    remote = RemoteEventBus("127.0.0.1", server.port)
    await remote.initialize()
    try:
        yield remote
    finally:
        await remote.stop()
        await server.stop()
        await backing.stop()


_fake_broker_seq = itertools.count()


@contextlib.asynccontextmanager
async def kafka_bus():
    from sitewhere_tpu_torch.kernel import fake_kafka
    from sitewhere_tpu_torch.kernel.kafka import KafkaEventBus

    # a bootstrap of its own per case: isolated fake-broker state
    bus = KafkaEventBus(f"fake-{next(_fake_broker_seq)}:9092",
                        client_mod=fake_kafka)
    await bus.initialize()
    try:
        yield bus
    finally:
        await bus.stop()


IMPLS = {"inproc": inproc_bus, "wire": wire_bus, "kafka": kafka_bus}


@pytest.fixture(params=list(IMPLS))
def bus_impl(request):
    return IMPLS[request.param]


async def _poll_until(c, n, max_records=64, timeout=15.0):
    got = []
    deadline = asyncio.get_running_loop().time() + timeout
    while len(got) < n:
        assert asyncio.get_running_loop().time() < deadline, (
            f"{len(got)} of {n} records in {timeout} s")
        got += await c.poll(max_records=max_records, timeout=2.0)
    return got


def test_contract_per_key_ordering(run, bus_impl):
    async def main():
        async with bus_impl() as bus:
            for i in range(20):
                await bus.produce("c-order", {"seq": i}, key="device-7")
            c = bus.subscribe("c-order", group="g1")
            seen = [r.value["seq"] for r in await _poll_until(c, 20)]
            assert seen == list(range(20))  # one key → one partition, FIFO
            c.close()

    run(main())


def test_contract_commit_resume_at_least_once(run, bus_impl):
    async def main():
        async with bus_impl() as bus:
            for i in range(10):
                await bus.produce("c-resume", {"i": i}, key="k")
            c = bus.subscribe("c-resume", group="g2")
            got = []
            deadline = asyncio.get_running_loop().time() + 15.0
            while len(got) < 10:
                assert asyncio.get_running_loop().time() < deadline
                got += [r.value["i"] for r in
                        await c.poll(max_records=4, timeout=2.0)]
                if len(got) == 4:
                    c.commit()  # only the first 4 committed
                    await asyncio.sleep(0.1)
            c.close()
            await asyncio.sleep(0.1)
            c2 = bus.subscribe("c-resume", group="g2")
            redelivered = [r.value["i"] for r in await _poll_until(c2, 6)]
            assert redelivered == [4, 5, 6, 7, 8, 9]
            c2.close()

    run(main())


def test_contract_independent_groups(run, bus_impl):
    async def main():
        async with bus_impl() as bus:
            for i in range(5):
                await bus.produce("c-groups", i, key="k")
            a = bus.subscribe("c-groups", group="ga")
            b = bus.subscribe("c-groups", group="gb")
            for c in (a, b):
                assert [r.value for r in await _poll_until(c, 5)] == [
                    0, 1, 2, 3, 4]
                c.close()

    run(main())


def test_contract_long_poll_wakes_on_produce(run, bus_impl):
    async def main():
        async with bus_impl() as bus:
            c = bus.subscribe("c-wake", group="gw")
            await c.poll(max_records=1, timeout=0.2)  # assignment settles

            async def later():
                await asyncio.sleep(0.1)
                await bus.produce("c-wake", "ping", key="k")

            t = asyncio.get_running_loop().create_task(later())
            t0 = asyncio.get_running_loop().time()
            records = []
            while not records:
                assert asyncio.get_running_loop().time() - t0 < 10.0
                records = await c.poll(max_records=10, timeout=10.0)
            waited = asyncio.get_running_loop().time() - t0
            await t
            assert [r.value for r in records] == ["ping"]
            assert waited < 5.0  # woke on produce, not the poll timeout
            c.close()

    run(main())


def test_kafka_bus_without_aiokafka_raises(monkeypatch):
    """With no client module given and aiokafka absent, the adapter
    refuses at construction, naming the package, as the JAX one does."""
    from sitewhere_tpu.kernel import kafka as jkafka
    from sitewhere_tpu_torch.kernel import kafka as tkafka

    errors = []
    for mod in (jkafka, tkafka):
        monkeypatch.setattr(mod, "aiokafka", None)
        with pytest.raises(RuntimeError) as exc:
            mod.KafkaEventBus("localhost:9092")
        errors.append(str(exc.value))
    assert "aiokafka" in errors[1] and errors[0] == errors[1]


# -- background-op retention ---------------------------------------------------


def test_spawn_logged_retains_and_surfaces_failures(run, caplog):
    from sitewhere_tpu_torch.kernel.kafka import _spawn_logged

    async def main():
        tasks: set = set()
        gate = asyncio.Event()

        async def held():
            await gate.wait()

        t = _spawn_logged(tasks, held())
        assert t in tasks          # strong ref while in flight
        gate.set()
        await t
        await asyncio.sleep(0)
        assert t not in tasks      # done callback prunes the set

        async def boom():
            raise RuntimeError("background op exploded")

        t2 = _spawn_logged(tasks, boom())
        await t2                   # _log_failure retrieves + logs
        await asyncio.sleep(0)
        assert t2 not in tasks

    with caplog.at_level(logging.ERROR,
                         logger="sitewhere_tpu_torch.kernel.kafka"):
        run(main())
    assert any("background operation failed" in r.getMessage()
               for r in caplog.records)


def test_kafka_produce_nowait_task_is_retained(run):
    async def main():
        async with kafka_bus() as bus:
            bus.produce_nowait("c-bg", {"i": 1}, key="k")
            assert bus._bg  # in-flight background produce strongly held
            deadline = asyncio.get_running_loop().time() + 10.0
            while bus._bg:  # drains once the produce settles
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)

    run(main())
