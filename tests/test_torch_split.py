"""The port's process-split deployment held to the JAX package's.

- The three-process instance of `tests/test_wire.py` on the port: a
  broker (an in-proc bus behind a `BusServer`), an ingest process (a
  fresh interpreter hosting event-sources only, fed by the simulator)
  and the pipeline runtime (device-management, inbound-processing,
  event-management, device-state) on a `RemoteEventBus`: telemetry
  decoded in one process is persisted in another.
- `tools/split.py` on the CPU at 512 devices, `lstm` (a dedicated
  session: K1's plain version) and `lstm-stream` (the megabatch pool):
  every event scored once, every consumer group drained, and the scores
  equal to the JAX package's split topology (its broker runtime and its
  scorer runtime on its own wire bus) fed the same seeded ticks, warm
  history and weights (moved through `convert.py`), within the
  pipeline tolerance of `ROADMAP.md` C (1e-2 plus 1e-3 relative at
  float16 readback). Both processes of the port run with UserWarning
  raised as an error: a read-only wire-delivered array reaching
  `torch.from_numpy` would fail the run.
- `read_state_topic` over a wire bus: the same `(snapshot, mutations)`
  from the port on its broker as from the JAX package on its own, and
  as from the port's in-proc `peek`.
"""

import asyncio
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.tools import split as tsplit

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-2, 1e-3
SPLIT_DEVICES = 512


async def wait_until(predicate, timeout=30.0, interval=0.02):
    deadline = asyncio.get_running_loop().time() + timeout
    while not predicate():
        if asyncio.get_running_loop().time() > deadline:
            raise TimeoutError("condition not met")
        await asyncio.sleep(interval)


# -- the three-process instance -----------------------------------------------

INGEST_PROC = r'''
import asyncio, sys
sys.path.insert(0, sys.argv[2])
import torch
torch.set_num_threads(1)

async def main():
    from sitewhere_tpu_torch.config import InstanceSettings
    from sitewhere_tpu_torch.kernel.bus import TopicNaming
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.kernel.wire import RemoteEventBus
    from sitewhere_tpu_torch.services import EventSourcesService
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    rt = ServiceRuntime(InstanceSettings(instance_id="split"),
                        bus=RemoteEventBus("127.0.0.1", int(sys.argv[1])))
    rt.add_service(EventSourcesService(rt))
    await rt.start()
    print("INGEST-UP", flush=True)
    eng = await rt.wait_for_engine("event-sources", "acme", timeout=60.0)
    receiver = eng.receiver("default")
    sim = DeviceSimulator(SimConfig(num_devices=50, seed=3), tenant_id="acme")
    for k in range(40):
        payload, _ = sim.payload(t=60.0 * k)
        assert await receiver.submit(payload)
    # the queue drains through decode + produce onto the broker
    decoded = rt.naming.tenant_topic("acme", TopicNaming.EVENT_SOURCE_DECODED)
    for _ in range(600):
        if sum(await rt.bus.end_offsets(decoded)) >= 40:
            break
        await asyncio.sleep(0.1)
    await rt.stop()
    print("INGEST-DONE", flush=True)

asyncio.run(main())
'''


def test_three_process_instance_scores_end_to_end(run):
    async def main():
        from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
        from sitewhere_tpu_torch.domain.model import DeviceType
        from sitewhere_tpu_torch.kernel.bus import EventBus
        from sitewhere_tpu_torch.kernel.service import ServiceRuntime
        from sitewhere_tpu_torch.kernel.wire import BusServer, RemoteEventBus
        from sitewhere_tpu_torch.services import (
            DeviceManagementService,
            DeviceStateService,
            EventManagementService,
            InboundProcessingService,
        )

        broker_bus = EventBus(default_partitions=4)
        await broker_bus.initialize()
        await broker_bus.start()
        broker = BusServer(broker_bus)
        await broker.start()
        rt = ServiceRuntime(InstanceSettings(instance_id="split"),
                            bus=RemoteEventBus("127.0.0.1", broker.port))
        for cls in (DeviceManagementService, InboundProcessingService,
                    EventManagementService, DeviceStateService):
            rt.add_service(cls(rt))
        await rt.start()
        await rt.add_tenant(TenantConfig(tenant_id="acme"))
        dm = rt.api("device-management").management("acme")
        dm.bootstrap_fleet(DeviceType(token="thermo", name="T"), 50)
        proc = subprocess.Popen(
            [sys.executable, "-u", "-c", INGEST_PROC, str(broker.port), REPO],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            em = rt.api("event-management").management("acme")
            deadline = asyncio.get_running_loop().time() + 120.0
            while em.telemetry.total_events < 50 * 40:
                await asyncio.sleep(0.1)
                assert asyncio.get_running_loop().time() < deadline, (
                    f"stalled at {em.telemetry.total_events} events; "
                    f"ingest rc={proc.poll()}")
            assert em.telemetry.total_events == 50 * 40
            # device-state consumes the same records in a group of its
            # own: it can trail event-management's count by a batch, so
            # it gets a wait of its own
            states = rt.api("device-state").state("acme")
            deadline = asyncio.get_running_loop().time() + 60.0
            while (states.get_state(7) or {}).get("last_seen") != 60.0 * 39:
                await asyncio.sleep(0.05)
                assert asyncio.get_running_loop().time() < deadline, (
                    f"device-state at {states.get_state(7)}")
            state = states.get_state(7)
            assert state["last_seen"] == 60.0 * 39
            out, err = await asyncio.get_running_loop().run_in_executor(
                None, lambda: proc.communicate(timeout=60))
            assert proc.returncode == 0, err.decode()[-2000:]
            assert b"INGEST-DONE" in out
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        await rt.stop()
        await broker.stop()
        await broker_bus.stop()

    run(main())


# -- tools/split.py against the JAX package's split topology ------------------


def _cfg(model: str, checkpoint=None) -> tsplit.SplitConfig:
    return tsplit.SplitConfig(
        devices=SPLIT_DEVICES, model=model, window=8,
        model_config={"hidden": 8}, burst_ticks=4, anomaly_at=2,
        paced_ticks=4, device="cpu", checkpoint=checkpoint, timeout_s=120.0)


def _weights(cfg) -> dict:
    """Numpy weights from the JAX model's own init."""
    from sitewhere_tpu.models import build_model

    model = build_model(cfg.model, window=cfg.window, **cfg.model_config)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(21)))


async def _jax_split(cfg, weights, payloads) -> dict:
    """The JAX package's split topology in this process: a broker
    runtime (in-proc bus, BusServer, event-sources) and a scorer runtime
    (the five services) on the JAX `RemoteEventBus`, the same tenant,
    warm history, weights and ticks; returns {(device, ts): score}."""
    from sitewhere_tpu import services as js
    from sitewhere_tpu.config import InstanceSettings, TenantConfig
    from sitewhere_tpu.domain.model import DeviceType
    from sitewhere_tpu.kernel.bus import EventBus, TopicNaming
    from sitewhere_tpu.kernel.service import ServiceRuntime
    from sitewhere_tpu.kernel.wire import BusServer, RemoteEventBus
    from sitewhere_tpu.sim.simulator import DeviceSimulator, SimConfig

    settings = lambda: InstanceSettings(  # noqa: E731
        instance_id="split-bench", trace_sample=1, flow_degrade_at=10.0,
        flow_defer_at=10.0)
    bus = EventBus(default_partitions=4)
    ingest = ServiceRuntime(settings(), bus=bus)
    ingest.add_service(js.EventSourcesService(ingest))
    await ingest.start()
    broker = BusServer(bus)
    await broker.start()
    scorer = ServiceRuntime(settings(),
                            bus=RemoteEventBus("127.0.0.1", broker.port))
    for cls in (js.DeviceManagementService, js.InboundProcessingService,
                js.EventManagementService, js.DeviceStateService,
                js.RuleProcessingService):
        scorer.add_service(cls(scorer))
    await scorer.start()
    consumer = bus.subscribe(ingest.naming.tenant_topic(
        tsplit.TENANT, TopicNaming.SCORED_EVENTS), group="meter")
    try:
        await scorer.add_tenant(TenantConfig(
            tenant_id=tsplit.TENANT, sections=tsplit.tenant_sections(cfg)))
        scorer.api("device-management").management(
            tsplit.TENANT).bootstrap_fleet(
            DeviceType(token="thermo", name="Thermometer"), cfg.devices)
        em = scorer.api("event-management").management(tsplit.TENANT)
        sim = DeviceSimulator(SimConfig(num_devices=cfg.devices,
                                        seed=cfg.seed),
                              tenant_id=tsplit.TENANT)
        for k in range(cfg.window + 4):
            em.telemetry.append_measurements(sim.tick(t=tsplit.TICK_S * k)[0])
        eng = scorer.api("rule-processing").engine(tsplit.TENANT)
        sink = eng.session or eng.pool_slot
        await wait_until(lambda: sink.ready, timeout=120.0)
        sink.swap_params(jax.tree.map(jax.numpy.asarray, weights))
        sink.reload_history()
        receiver = (await ingest.wait_for_engine(
            "event-sources", tsplit.TENANT, timeout=60.0)).receiver("default")
        for payload in payloads:
            assert await receiver.submit(payload)
        want = len(payloads) * cfg.devices
        scored: dict = {}
        deadline = asyncio.get_running_loop().time() + 120.0
        while len(scored) < want:
            assert asyncio.get_running_loop().time() < deadline, len(scored)
            for rec in await consumer.poll(max_records=512, timeout=0.5):
                b = rec.value
                for d, ts, s in zip(b.device_index.tolist(), b.ts.tolist(),
                                    b.score.tolist()):
                    assert (d, ts) not in scored
                    scored[(d, ts)] = s
        return scored
    finally:
        consumer.close()
        await broker.stop()
        await scorer.stop()
        await ingest.stop()


@pytest.mark.filterwarnings("error::UserWarning")
@pytest.mark.parametrize("model", ["lstm", "lstm-stream"])
def test_split_matches_jax_split(run, tmp_path, monkeypatch, model):
    from sitewhere_tpu_torch.training.checkpoint import CheckpointStore

    cfg = _cfg(model, checkpoint=str(tmp_path / "ckpt"))
    weights = _weights(cfg)
    CheckpointStore(cfg.checkpoint).save(tsplit.TENANT, model, weights)
    # the scorer process too: a warning there is an error
    monkeypatch.setenv("PYTHONWARNINGS", "error::UserWarning")
    report, record = run(tsplit.run(cfg))
    assert report["events"] == (cfg.burst_ticks + cfg.paced_ticks) * 512
    assert report["dispatches"] >= cfg.burst_ticks + cfg.paced_ticks
    # the plain version on the CPU: no kernel launch
    assert report["kernel_launches"] == 0
    assert report["burst"]["device"] == "cpu"
    assert report["child_exit"] == 0
    assert {"bench.inbound-processing", "bench.rule-processing",
            "bench.event-management"} <= set(report["groups_drained"])
    got = tsplit.check_once("split", [b for b, _ in record["ticks"]],
                            record["burst"] + record["paced"])
    want = run(_jax_split(cfg, weights,
                          [b.encode() for b, _ in record["ticks"]]))
    assert set(got) == set(want)
    keys = sorted(want)
    np.testing.assert_allclose([got[k][0] for k in keys],
                               [want[k] for k in keys], atol=ATOL, rtol=RTOL)
    # the anomalous tick stands out in both
    spike, hot = record["ticks"][cfg.anomaly_at]
    scores = np.array([got[(d, ts)][0] for d, ts in zip(
        spike.device_index.tolist(), spike.ts.tolist())])
    assert np.median(scores[hot]) > np.median(scores[~hot])


def test_split_command_prints_its_report(capsys):
    """`python -m sitewhere_tpu_torch.tools.split --cpu --devices N
    --model M`: one JSON report, every event scored and the scorer's
    exit 0."""
    import json

    assert tsplit.main(["--cpu", "--devices", "64",
                        "--model", "lstm-stream"]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg = tsplit.SplitConfig()
    assert report["events"] == (cfg.burst_ticks + cfg.paced_ticks) * 64
    assert report["burst"]["scored"] == cfg.burst_ticks * 64
    assert report["paced"]["scored"] == cfg.paced_ticks * 64
    assert report["model"] == "lstm-stream" and report["child_exit"] == 0


def test_split_child_failure_surfaces_its_stderr(run, monkeypatch):
    """A scorer that dies before READY fails the run with its exit code
    and the tail of its stderr, never a hang on its stdout."""
    monkeypatch.setattr(tsplit, "_CHILD_SRC", "import sys; sys.stderr.write("
                        "'scorer could not start'); sys.exit(3)")
    cfg = tsplit.SplitConfig(devices=64, model="lstm", window=8,
                             burst_ticks=1, paced_ticks=0, device="cpu",
                             timeout_s=30.0)
    with pytest.raises(tsplit.ChildDied,
                       match="(?s)exited with 3.*scorer could not start"):
        run(tsplit.run(cfg))


# -- read_state_topic over a wire bus ------------------------------------------

STATE_RECORDS = [
    {"kind": "mut", "seq": 1, "op": "put", "table": "devices",
     "entity": {"token": "dev-0"}},
    {"kind": "snap", "seq": 1, "snapshot": {"seq": 1, "tables": {
        "devices": [{"token": "dev-0"}]}}},
    {"kind": "mut", "seq": 2, "op": "put", "table": "devices",
     "entity": {"token": "dev-1"}},
    "not a record",
    {"kind": "snap", "seq": 0, "snapshot": {"seq": 0, "tables": {}}},
    {"kind": "mut", "seq": 3, "op": "delete", "table": "devices",
     "entity": {"token": "dev-0"}},
    {"kind": "mut", "seq": 1, "op": "put", "table": "devices",
     "entity": {"token": "stale"}},
]


async def _read_state(pkg_root: str, wire: bool):
    import importlib

    bus_mod = importlib.import_module(f"{pkg_root}.kernel.bus")
    wire_mod = importlib.import_module(f"{pkg_root}.kernel.wire")
    replication = importlib.import_module(f"{pkg_root}.services.replication")
    naming = bus_mod.TopicNaming("i")
    backing = bus_mod.EventBus(default_partitions=2)
    await backing.initialize()
    await backing.start()
    topic = naming.tenant_topic("t", bus_mod.TopicNaming.REGISTRY_STATE)
    for value in STATE_RECORDS:
        await backing.produce(topic, value, key="t")
    server = remote = None
    try:
        if wire:
            server = wire_mod.BusServer(backing)
            await server.start()
            remote = wire_mod.RemoteEventBus("127.0.0.1", server.port)
            await remote.initialize()
        rt = SimpleNamespace(naming=naming, bus=remote or backing)
        return await asyncio.wait_for(
            replication.read_state_topic(rt, "t", reader_tag="w0"), 30.0)
    finally:
        if remote is not None:
            await remote.stop()
        if server is not None:
            await server.stop()
        await backing.stop()


def test_read_state_topic_over_the_wire_matches_jax(run):
    want = run(_read_state("sitewhere_tpu", wire=True))
    snap, muts = want
    assert snap["seq"] == 1 and [m["seq"] for m in muts] == [2, 3]
    assert run(_read_state("sitewhere_tpu_torch", wire=True)) == want
    assert run(_read_state("sitewhere_tpu_torch", wire=False)) == want
