"""The port's service runtime modules held against the JAX package's on
the same inputs (bus, flow control, codec and SWB1, the lane predicates,
metrics, the copied registry constants), and every path the port does
not take over yet raising `NotImplementedError` that names its ROADMAP
item. Everything here is host code: the comparisons are exact."""

import itertools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu.analysis import registry as jregistry
from sitewhere_tpu.domain import batch as jbatch
from sitewhere_tpu.domain import model as jmodel
from sitewhere_tpu.kernel import bus as jbus
from sitewhere_tpu.kernel import codec as jcodec
from sitewhere_tpu.kernel import egresslane as jegress
from sitewhere_tpu.kernel import fastlane as jfast
from sitewhere_tpu.kernel import flow as jflow
from sitewhere_tpu.kernel import metrics as jmetrics
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.domain import model as tmodel
from sitewhere_tpu_torch.kernel import bus as tbus
from sitewhere_tpu_torch.kernel import codec as tcodec
from sitewhere_tpu_torch.kernel import egresslane as tegress
from sitewhere_tpu_torch.kernel import fastlane as tfast
from sitewhere_tpu_torch.kernel import faults as tfaults
from sitewhere_tpu_torch.kernel import flow as tflow
from sitewhere_tpu_torch.kernel import metrics as tmetrics
from sitewhere_tpu_torch.kernel import tracing as ttracing

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(batch=jbatch, bus=jbus, codec=jcodec, config=jconfig,
                      egress=jegress, fast=jfast, flow=jflow,
                      metrics=jmetrics, model=jmodel)
PORT = SimpleNamespace(batch=tbatch, bus=tbus, codec=tcodec, config=tconfig,
                       egress=tegress, fast=tfast, flow=tflow,
                       metrics=tmetrics, model=tmodel)


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


# -- what the port does not take over yet ----------------------------------------

def _runtime(**settings):
    from sitewhere_tpu_torch.cli import build_runtime

    return build_runtime(tconfig.InstanceSettings(device="cpu", **settings))


def _engine(service: str, sections: dict):
    rt = _runtime()
    return rt.services[service].create_tenant_engine(
        tconfig.TenantConfig(tenant_id="t", sections=sections))


CUTS = {
    "wire-bus": (lambda: _runtime().__class__(
        tconfig.InstanceSettings(device="cpu"), bus=object()), "A.1.2"),
    "remote-service": (lambda: _runtime().add_remote_service(
        "device-management", "127.0.0.1", 1), "A.1.2"),
    "data-dir": (lambda: _runtime(data_dir="/nonexistent"), "A.1.3"),
    "registry-data-dir": (lambda: _engine(
        "device-management", {"device-management": {"data_dir": "/x"}}),
        "A.1.3"),
    "registry-replication": (lambda: _engine(
        "device-management", {"device-management": {"replicate": True}}),
        "A.1.3"),
    "event-log-data-dir": (lambda: _engine(
        "event-management", {"event-management": {"data_dir": "/x"}}),
        "A.1.3"),
    "geofences": (lambda: _engine(
        "rule-processing", {"rule-processing": {"geofences": [{"id": "z"}]}}),
        "A.1.4"),
    "mesh": (lambda: _runtime().services["rule-processing"].shared_pool(
        "zscore", {}, __import__(
            "sitewhere_tpu_torch.scoring.server",
            fromlist=["ScoringConfig"]).ScoringConfig(),
        {"data": 2, "model": 2}), "A.2"),
    "demo-rest-port": (lambda: __import__(
        "sitewhere_tpu_torch.cli", fromlist=["main"]).main(
        ["demo", "--cpu", "--port", "8080"]), "A.1.4"),
    **{f"receiver-{kind}": ((lambda kind=kind: _engine(
        "event-sources", {"event-sources": {"receivers": [
            {"kind": kind, "decoder": "swb1", "name": "r"}]}})), "A.1.1")
       for kind in ("mqtt", "websocket", "coap", "amqp", "stomp")},
}


@pytest.mark.parametrize("cut", list(CUTS))
def test_cut_raises_naming_its_roadmap_item(cut):
    make, item = CUTS[cut]
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}:"):
        make()


def test_forecast_raises_lookup_error_as_the_reference_does(run):
    """No port model has a forecast surface yet: the query raises
    LookupError, as the JAX package does for zscore and lstm."""
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
