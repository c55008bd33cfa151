"""The port's service runtime modules held against the JAX package's on
the same inputs (bus, flow control, codec and SWB1, the lane predicates,
metrics, the copied registry constants), the storage plane through the
runtime (a `data_dir` restart in either package from either package's
files, registry adoption from the in-process `registry-state` topic,
`cli replay`). Everything here is host code: the comparisons are
exact."""

import asyncio
import contextlib
import io
import itertools
import json
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sitewhere_tpu import cli as jcli
from sitewhere_tpu import config as jconfig
from sitewhere_tpu import services as jservices
from sitewhere_tpu.analysis import registry as jregistry
from sitewhere_tpu.domain import batch as jbatch
from sitewhere_tpu.domain import model as jmodel
from sitewhere_tpu.kernel import bus as jbus
from sitewhere_tpu.kernel import codec as jcodec
from sitewhere_tpu.kernel import egresslane as jegress
from sitewhere_tpu.kernel import fastlane as jfast
from sitewhere_tpu.kernel import flow as jflow
from sitewhere_tpu.kernel import metrics as jmetrics
from sitewhere_tpu.kernel import service as jservice
from sitewhere_tpu.sim import simulator as jsim
from sitewhere_tpu_torch import cli as tcli
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch import services as tservices
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.domain import model as tmodel
from sitewhere_tpu_torch.kernel import bus as tbus
from sitewhere_tpu_torch.kernel import codec as tcodec
from sitewhere_tpu_torch.kernel import egresslane as tegress
from sitewhere_tpu_torch.kernel import fastlane as tfast
from sitewhere_tpu_torch.kernel import faults as tfaults
from sitewhere_tpu_torch.kernel import flow as tflow
from sitewhere_tpu_torch.kernel import metrics as tmetrics
from sitewhere_tpu_torch.kernel import service as tservice
from sitewhere_tpu_torch.kernel import tracing as ttracing
from sitewhere_tpu_torch.sim import simulator as tsim

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(batch=jbatch, bus=jbus, codec=jcodec, config=jconfig,
                      egress=jegress, fast=jfast, flow=jflow,
                      metrics=jmetrics, model=jmodel, service=jservice,
                      services=jservices, sim=jsim, settings={})
PORT = SimpleNamespace(batch=tbatch, bus=tbus, codec=tcodec, config=tconfig,
                       egress=tegress, fast=tfast, flow=tflow,
                       metrics=tmetrics, model=tmodel, service=tservice,
                       services=tservices, sim=tsim,
                       settings={"device": "cpu"})


# -- bus ---------------------------------------------------------------------

async def _bus_trace(pkg) -> list:
    """One produce/poll/commit/rebalance sequence; what each step saw."""
    bus = pkg.bus.EventBus(default_partitions=3, retention=16)
    out = []
    a = bus.subscribe("t.events", group="g")
    for i in range(12):
        await bus.produce("t.events", {"i": i}, key=f"k{i % 5}")
    out.append(bus.end_offsets("t.events"))
    recs = a.poll_nowait(max_records=5)
    out.append([(r.partition, r.offset, r.key, r.value) for r in recs])
    a.commit()
    b = bus.subscribe("t.events", group="g")  # rebalance: partitions split
    out.append((sorted(a.assignment), sorted(b.assignment)))
    for c in (a, b):
        got = await c.poll(max_records=64, timeout=0.01)
        out.append([(r.partition, r.offset, r.value) for r in got])
        c.commit()
    for i in range(30):  # past retention: trimmed records are counted
        bus.produce_nowait("t.events", {"j": i}, key="k1")
    got = b.poll_nowait(max_records=64) + a.poll_nowait(max_records=64)
    out.append(sorted((r.partition, r.offset) for r in got))
    out.append((a.lost_records, b.lost_records))
    out.append(sorted(bus._groups["g"].committed.items()))
    out.append(bus.group_lags(events=True))
    return out


def test_bus_sequences_match(run):
    assert run(_bus_trace(PORT)) == run(_bus_trace(JAX))


# -- flow control --------------------------------------------------------------

def _flow_trace(pkg) -> list:
    now = [0.0]
    settings = pkg.config.InstanceSettings(flow_default_rate=100.0,
                                           flow_default_burst=50.0)
    fc = pkg.flow.FlowController(settings, pkg.metrics.MetricsRegistry(),
                                 clock=lambda: now[0])
    tenants = [pkg.config.TenantConfig(tenant_id="a"),
               pkg.config.TenantConfig(tenant_id="b", sections={
                   "flow": {"rate": 10.0, "burst": 5.0, "weight": 2.0}})]
    for t in tenants:
        fc.configure_tenant(t)
    out = []
    rng = np.random.default_rng(7)
    for step in range(200):
        now[0] += float(rng.uniform(0.0, 0.05))
        tid = "ab"[step % 2]
        d = fc.admit_ingress(tid, float(rng.integers(1, 20)))
        mode = fc.report_scorer(tid, pending=int(rng.integers(0, 1200)),
                                cap=1000, inflight=int(rng.integers(0, 8)),
                                max_inflight=8)
        if step % 37 == 0:
            fc.note_dead_letter(tid)
        out.append((d.admitted, d.reason, round(d.retry_after, 6), mode,
                    fc.shed_mode(tid)))
    out.append(fc.modes())
    out.append(fc.quota("b"))
    return out


def test_flow_controller_admissions_and_modes_match():
    assert _flow_trace(PORT) == _flow_trace(JAX)


def test_degraded_zscore_matches():
    rng = np.random.default_rng(3)
    j, t = jflow.DegradedZscore(), tflow.DegradedZscore()
    for _ in range(20):
        dev = rng.integers(0, 300, 64).astype(np.uint32)
        val = rng.normal(20.0, 2.0, 64).astype(np.float32)
        np.testing.assert_array_equal(t.score(dev, val), j.score(dev, val))


# -- codec and SWB1 ------------------------------------------------------------

def _values(pkg) -> dict:
    b, m, c = pkg.batch, pkg.model, pkg.config
    ctx = b.BatchContext(tenant_id="t", source="gw", trace_id=42,
                         ingest_monotonic=1.0, fastlane=True)
    n = 5
    dev = np.arange(n, dtype=np.uint32)
    ts = np.linspace(1.0, 5.0, n)
    return {
        "measurements": b.MeasurementBatch(ctx, dev, np.zeros(n, np.uint16),
                                           np.arange(n, dtype=np.float32),
                                           ts),
        "locations": b.LocationBatch(ctx, dev, ts * 2.0, ts * 3.0,
                                     np.ones(n, np.float32), ts),
        "alerts": b.AlertBatch(ctx, dev[:2], np.array([1, 2], np.uint8),
                               ["x", "y"], ["m1", "m2"], ts[:2], "model"),
        "registration": b.RegistrationBatch(ctx, ["a", "b"], "thermo",
                                            area_token="z",
                                            metadata={"k": 1}),
        "ack": b.RegistrationAck(["a", "b"], [b.ACK_NEW, b.ACK_REJECTED],
                                 [3, -1]),
        "scored": b.ScoredBatch(ctx, dev, np.ones(n, np.float32),
                                np.zeros(n, bool), ts, model_version=3),
        "tenant": c.TenantConfig(tenant_id="t", name="T", sections={
            "rule-processing": {"model": "lstm", "buckets": [256]}}),
        "device": m.Device(id="d1", created_date=1.0, updated_date=1.0,
                           token="dev-1", device_type_id="dt"),
        "record": {"device_indices": dev, "ctx": ctx, "n": [1, 2.5, None]},
    }


def _same(x, y) -> None:
    if isinstance(x, np.ndarray):
        np.testing.assert_array_equal(x, y)
    elif isinstance(x, dict):
        assert x.keys() == y.keys()
        for k in x:
            _same(x[k], y[k])
    elif isinstance(x, (list, tuple)):
        assert len(x) == len(y)
        for a, b in zip(x, y):
            _same(a, b)
    elif hasattr(x, "__dataclass_fields__"):
        assert type(x).__name__ == type(y).__name__
        for f in x.__dataclass_fields__:
            _same(getattr(x, f), getattr(y, f))
    else:
        assert x == y


@pytest.mark.parametrize("name", list(_values(JAX)))
@pytest.mark.parametrize("way", ["jax-to-port", "port-to-jax"])
def test_codec_round_trips_between_packages(name, way):
    src, dst = (JAX, PORT) if way == "jax-to-port" else (PORT, JAX)
    value = _values(src)[name]
    wire = src.codec.encode(value)
    assert wire == dst.codec.encode(_values(dst)[name])
    got = dst.codec.decode(wire)
    if hasattr(got, "__dataclass_fields__"):
        assert type(got) is type(_values(dst)[name])
    _same(got, _values(dst)[name])


@pytest.mark.parametrize("name", ["measurements", "locations",
                                  "registration", "ack"])
@pytest.mark.parametrize("way", ["jax-to-port", "port-to-jax"])
def test_swb1_frames_decode_in_the_other_package(name, way):
    src, dst = (JAX, PORT) if way == "jax-to-port" else (PORT, JAX)
    frame = _values(src)[name].encode()
    want = _values(dst)[name]
    assert frame == want.encode()
    if name == "ack":
        got = type(want).decode(frame)
    else:
        got = type(want).decode(frame, want.ctx)
    for f in want.__dataclass_fields__:
        if f != "ctx":
            _same(getattr(got, f), getattr(want, f))


# -- the lane predicates -------------------------------------------------------

TENANT_SECTIONS = {
    "default": {},
    "no-model": {"rule-processing": {"model": None}},
    "scripts": {"rule-processing": {"model": "zscore",
                                    "scripts": {"s": "async def hook(e, a): pass"}}},
    "geofences": {"rule-processing": {"model": "zscore",
                                      "geofences": [{"id": "z"}]}},
    "fastlane-off": {"fastlane": {"enabled": False}},
    "fastlane-on-no-model": {"fastlane": {"enabled": True},
                             "rule-processing": {"model": None}},
    "egress-unfused": {"egress": {"fused": False, "lanes": 2}},
    "egress-lanes": {"egress": {"lanes": "3", "autotune": True,
                                "max_lanes": 6}},
}
SERVICE_SETS = {"both": ("rule-processing", "device-management"),
                "no-rules": ("device-management",), "none": ()}


@pytest.mark.parametrize("sections", list(TENANT_SECTIONS))
def test_lane_predicates_match(sections):
    for services, fused_default in itertools.product(SERVICE_SETS, (True, False)):
        answers = []
        for pkg in (JAX, PORT):
            rt = SimpleNamespace(
                bus=pkg.bus.EventBus(),
                services={s: object() for s in SERVICE_SETS[services]},
                settings=pkg.config.InstanceSettings(
                    egress_fused=fused_default))
            tenant = pkg.config.TenantConfig(
                tenant_id="t", sections=TENANT_SECTIONS[sections])
            answers.append((pkg.fast.fastlane_enabled(tenant, rt),
                            pkg.egress.egress_fused(tenant, rt),
                            pkg.egress.egress_lanes(tenant, rt),
                            pkg.egress.egress_autotune(tenant, rt),
                            pkg.egress.egress_max_lanes(tenant, rt)))
        assert answers[0] == answers[1], (services, fused_default)


# -- metrics and the copied registry constants ---------------------------------

def _metrics_text(pkg) -> str:
    reg = pkg.metrics.MetricsRegistry()
    reg.counter("scoring.dispatches").inc(3)
    reg.gauge("flow.pressure:t").set(0.25)
    h = reg.histogram("scoring.e2e_latency_s")
    h.observe_array(np.linspace(1e-4, 0.2, 500))
    h.reset()
    h.observe_array(np.linspace(1e-3, 0.05, 100))
    return reg.prometheus_text()


def test_metrics_prometheus_text_matches():
    assert _metrics_text(PORT) == _metrics_text(JAX)


def test_registry_constants_match_the_reference():
    assert tfaults.FAULT_SITES == jregistry.FAULT_SITES
    assert ttracing.TRACE_STAGES == jregistry.TRACE_STAGES


def _runtime(**settings):
    from sitewhere_tpu_torch.cli import build_runtime

    return build_runtime(tconfig.InstanceSettings(device="cpu", **settings))


def test_forecast_raises_lookup_error_as_the_reference_does(run):
    """A model without a forecast surface (zscore): the query raises
    LookupError, as the JAX package does. Models with one (lstm, tft)
    answer it: tests/test_torch_forecasters.py holds them to the JAX
    package's answers."""
    async def main():
        rt = _runtime()
        await rt.start()
        try:
            await rt.add_tenant(tconfig.TenantConfig(
                tenant_id="t", sections={"rule-processing": {
                    "model": "zscore", "buckets": [64]}}))
            eng = rt.api("rule-processing").engine("t")
            with pytest.raises(LookupError, match="no forecast surface"):
                await eng.forecast_device(0)
        finally:
            await rt.stop()

    run(main())


def test_shared_runtime_pieces_stay_in_process(run):
    """Two runtimes may share one in-process bus (the owner manages its
    lifecycle); the other keeps it unmanaged."""
    async def main():
        owner = _runtime(instance_id="a")
        guest = owner.__class__(tconfig.InstanceSettings(
            instance_id="b", device="cpu"), bus=owner.bus)
        assert owner.bus.parent is owner and guest.bus is owner.bus
        await owner.start()
        await owner.stop()

    run(main())


# -- the storage plane through the runtime ----------------------------------------

STORAGE_SERVICES = ("DeviceManagementService", "EventSourcesService",
                    "InboundProcessingService", "EventManagementService",
                    "DeviceStateService")
FLEET, TICKS = 64, 10


def _storage_runtime(pkg, data_dir, **settings):
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="dur", data_dir=data_dir, **pkg.settings, **settings))
    for name in STORAGE_SERVICES:
        rt.add_service(getattr(pkg.services, name)(rt))
    return rt


async def _wait(cond, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.01)


async def _life(pkg, data_dir, feed: bool) -> dict:
    """One runtime life on `data_dir`: with `feed`, register the fleet,
    deactivate device 3 and submit TICKS fleet ticks (every fourth with
    anomalies) through the tenant's receiver; then read the store and
    the registry back and stop."""
    rt = _storage_runtime(pkg, data_dir)
    await rt.start()
    try:
        await rt.add_tenant(pkg.config.TenantConfig(
            tenant_id="acme", sections={"event-management": {"history": 64}}))
        dm = rt.api("device-management").management("acme")
        em = rt.api("event-management").management("acme")
        restored = dm.restored_from
        if feed:
            devices = dm.bootstrap_fleet(pkg.model.DeviceType(token="thermo"),
                                         FLEET)
            dm.set_device_status(devices[3].id, "inactive")
            sim = pkg.sim.DeviceSimulator(pkg.sim.SimConfig(
                num_devices=FLEET, seed=11), tenant_id="acme")
            rc = rt.api("event-sources").engine("acme").receiver("default")
            for k in range(TICKS):
                sim.cfg = pkg.sim.SimConfig(
                    num_devices=FLEET, seed=11,
                    anomaly_rate=0.1 if k % 4 == 3 else 0.0,
                    anomaly_magnitude=12.0)
                assert await rc.submit(sim.tick(t=60.0 * k)[0].encode())
            want = TICKS * (FLEET - 1)
            await _wait(lambda: em.telemetry.total_events == want)
        x, valid = em.telemetry.window(np.arange(FLEET), 16)
        registry = sorted((d.index, d.token, d.status)
                          for d in dm.spi.devices.by_id.values())
        out = {"restored_from": restored, "x": x, "valid": valid,
               "ts": em.telemetry.channel(0).window_ts(np.arange(FLEET), 16),
               "total": em.telemetry.total_events, "registry": registry,
               "mask": dm.registered_mask(np.arange(FLEET + 1))}
    finally:
        await rt.stop()
    return out


@pytest.mark.parametrize("writer,restarter", [
    ("port", "port"), ("jax", "jax"), ("jax", "port"), ("port", "jax")])
def test_data_dir_restart_restores_store_and_registry(run, tmp_path, writer,
                                                      restarter):
    """A runtime ingests through its receiver on `data_dir`, stops, and a
    fresh runtime (either package) restarts on the directory: the store
    windows, the registry (device 3 still inactive) and `restored_from`
    come back as the writer left them, and the port's first life equals
    the JAX package's."""
    src = JAX if writer == "jax" else PORT
    dst = JAX if restarter == "jax" else PORT
    first = run(_life(src, str(tmp_path), feed=True))
    second = run(_life(dst, str(tmp_path), feed=False))
    reference = run(_life(JAX if writer == "port" else PORT,
                          str(tmp_path / "other"), feed=True))
    assert first["restored_from"] is None
    assert second["restored_from"] == "snapshot+wal"
    for life in (second, reference):
        for key in ("x", "valid", "ts", "mask"):
            np.testing.assert_array_equal(life[key], first[key], err_msg=key)
        assert life["total"] == first["total"] == TICKS * (FLEET - 1)
        assert life["registry"] == first["registry"]
    assert not first["mask"][3] and first["mask"][:3].all()
    assert not first["valid"][3].any() and first["valid"][4].sum() == TICKS


async def _snapshot_current(data_dir) -> list:
    """`snapshot_current` before and after each registry snapshot."""
    from sitewhere_tpu_torch.persistence.durable import load_snapshot

    rt = _storage_runtime(PORT, data_dir)
    await rt.start()
    try:
        await rt.add_tenant(PORT.config.TenantConfig(
            tenant_id="acme",
            sections={"device-management": {"snapshot_interval_s": 0.05}}))
        dm = rt.api("device-management").management("acme")
        seen = [dm.snapshot_current]  # nothing registered, nothing saved
        devices = dm.bootstrap_fleet(PORT.model.DeviceType(token="thermo"), 16)
        seen.append(dm.snapshot_current)
        await _wait(lambda: dm.snapshot_current)
        path = f"{data_dir}/tenants/acme/registry.snap"
        seen.append(load_snapshot(path)["seq"] == dm.spi.mutations)
        dm.set_device_status(devices[3].id, "inactive")
        seen.append(dm.snapshot_current)
        await _wait(lambda: dm.snapshot_current)
        seen.append(load_snapshot(path)["seq"] == dm.spi.mutations)
    finally:
        await rt.stop()
    return seen


def test_snapshot_current_follows_the_registry_snapshots(run, tmp_path):
    """The port's `snapshot_current` (what `tools/pipeline.build` waits
    on before traffic) turns true only once a written snapshot covers
    every registry mutation."""
    assert run(_snapshot_current(str(tmp_path))) == [
        False, False, True, False, True]


async def _adopt(pkg, data_dir) -> tuple:
    """A writer runtime replicates its registry to the in-process
    `registry-state` topic and stops (sealing it with a snapshot); a
    second runtime on the same bus with an EMPTY data_dir adopts the
    tenant from the topic alone."""
    owner = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="broker", **pkg.settings))
    await owner.start()
    try:
        writer = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
            instance_id="fleet", registry_replication=True, **pkg.settings),
            bus=owner.bus)
        writer.add_service(pkg.services.DeviceManagementService(writer))
        await writer.start()
        tenant = pkg.config.TenantConfig(tenant_id="acme")
        await writer.add_tenant(tenant)
        dm = writer.api("device-management").management("acme")
        devices = dm.bootstrap_fleet(pkg.model.DeviceType(token="thermo"), 24)
        dm.set_device_status(devices[5].id, "inactive")
        await asyncio.sleep(0.05)
        await writer.stop()
        adopter = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
            instance_id="fleet", registry_replication=True, data_dir=data_dir,
            **pkg.settings), bus=owner.bus)
        adopter.add_service(pkg.services.DeviceManagementService(adopter))
        await adopter.start()
        try:
            await adopter.add_tenant(tenant)
            dm2 = adopter.api("device-management").management("acme")
            kinds = [r.value["kind"] for r in owner.bus.peek(
                adopter.naming.tenant_topic("acme", "registry-state"),
                limit=-1)]
            return (dm2.restored_from,
                    sorted((d.index, d.token, d.status)
                           for d in dm2.spi.devices.by_id.values()),
                    dm2.registered_mask(np.arange(25)).tolist(),
                    kinds[0], kinds[-1])
        finally:
            await adopter.stop()
    finally:
        await owner.stop()


def test_registry_adoption_from_the_state_topic(run, tmp_path):
    got = run(_adopt(PORT, str(tmp_path / "port")))
    want = run(_adopt(JAX, str(tmp_path / "jax")))
    assert got == want
    assert got[0] == "bus-replay" and len(got[1]) == 24
    assert got[2][5] is False and got[2][:5] == [True] * 5
    assert (got[3], got[4]) == ("snap", "snap")


def _replay_report(main, data_dir) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(["replay", "--data-dir", data_dir, "--tenant", "acme",
                     "--cpu"]) == 0
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    report.pop("elapsed_s")
    report.pop("rate")
    return report


def test_cli_replay_matches_jax_on_a_port_data_dir(run, tmp_path):
    """`cli replay --cpu` on a directory the port's runtime wrote reports
    what the JAX package's `swx replay` reports on a copy of it."""
    run(_life(PORT, str(tmp_path / "port"), feed=True))
    shutil.copytree(tmp_path / "port", tmp_path / "jax")
    got = _replay_report(tcli.main, str(tmp_path / "port"))
    want = _replay_report(jcli.main, str(tmp_path / "jax"))
    assert got == want
    assert got["events"] == got["scored"] == TICKS * (FLEET - 1)
    assert got["windows"] == TICKS
