"""Geofences in both packages: `points_in_polygon` (host numpy in both)
and the `GeofenceHook`'s transition alerts.

- `points_in_polygon`: equal results, exactly, on seeded points and on
  hypothesis-drawn ones, including polygon vertices and points on
  edges (the ray cast's half-open rule decides those the same way on
  both sides).
- The hook through the rule-processing engine: the same location
  sequence produces the same zone.enter / zone.exit alerts (device,
  type, level, message, in order) in a JAX runtime and a port runtime
  (`device="cpu"`).
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sitewhere_tpu import config as jconfig
from sitewhere_tpu import services as jservices
from sitewhere_tpu.domain import batch as jbatch
from sitewhere_tpu.domain import model as jmodel
from sitewhere_tpu.kernel import service as jservice
from sitewhere_tpu.services import geofence as jgeo
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch import services as tservices
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.domain import model as tmodel
from sitewhere_tpu_torch.kernel import service as tservice
from sitewhere_tpu_torch.services import geofence as tgeo

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

SQUARE = ((0.0, 0.0), (0.0, 10.0), (10.0, 10.0), (10.0, 0.0))
ELL = ((0.0, 0.0), (0.0, 10.0), (4.0, 10.0), (4.0, 4.0), (10.0, 4.0),
       (10.0, 0.0))
STAR = tuple((float(np.cos(a) * r), float(np.sin(a) * r)) for a, r in zip(
    np.linspace(0, 2 * np.pi, 10, endpoint=False), [9, 3] * 5))
POLYGONS = {"square": SQUARE, "ell": ELL, "star": STAR,
            "degenerate": ((0.0, 0.0), (1.0, 1.0))}


def _boundary_points(poly):
    """Each vertex, each edge's midpoint and quarter points."""
    p = np.asarray(poly, np.float64)
    q = np.roll(p, -1, axis=0)
    pts = [p] + [p + (q - p) * t for t in (0.25, 0.5, 0.75)]
    return np.concatenate(pts)


@pytest.mark.parametrize("name", list(POLYGONS))
def test_points_in_polygon_equal_on_seeded_points(name):
    poly = POLYGONS[name]
    rng = np.random.default_rng(11)
    pts = np.concatenate([rng.uniform(-12, 12, (4000, 2)),
                          _boundary_points(poly)])
    lat, lon = pts[:, 0].copy(), pts[:, 1].copy()
    got = tgeo.points_in_polygon(lat, lon, poly)
    want = jgeo.points_in_polygon(lat, lon, poly)
    assert got.dtype == want.dtype == bool
    np.testing.assert_array_equal(got, want)
    if name == "square":
        assert got[:4000].any() and not got[:4000].all()


coord = st.floats(-20, 20, allow_nan=False, width=64)


@settings(max_examples=60, deadline=None)
@given(vertices=st.lists(st.tuples(coord, coord), min_size=3, max_size=9),
       points=st.lists(st.tuples(coord, coord), min_size=1, max_size=40))
def test_points_in_polygon_equal_on_drawn_points(vertices, points):
    pts = np.asarray(points + [v for v in vertices], np.float64)
    pts = np.concatenate([pts, _boundary_points(vertices)])
    lat, lon = pts[:, 0].copy(), pts[:, 1].copy()
    np.testing.assert_array_equal(
        tgeo.points_in_polygon(lat, lon, vertices),
        jgeo.points_in_polygon(lat, lon, vertices))


JAX = SimpleNamespace(config=jconfig, services=jservices, service=jservice,
                      batch=jbatch, model=jmodel, settings={})
PORT = SimpleNamespace(config=tconfig, services=tservices, service=tservice,
                       batch=tbatch, model=tmodel, settings={"device": "cpu"})

# (devices, lat, lon, ts) per step: devices enter, dwell, exit, re-enter;
# one batch reports a device twice (the newest report wins)
STEPS = [
    ([0, 1, 2, 3], [5.0, 2.0, 50.0, 9.0], [5.0, 2.0, 50.0, 1.0],
     [1.0, 1.0, 1.0, 1.0]),
    ([0, 3], [6.0, 3.0], [6.0, 3.0], [2.0, 2.0]),
    ([0, 1, 0], [60.0, 3.0, 7.0], [6.0, 3.0, 7.0], [3.0, 3.0, 2.5]),
    ([0, 2], [60.0, 5.0], [6.0, 5.0], [4.0, 4.0]),
    ([0, 1, 2, 3], [5.0, 70.0, 80.0, 2.0], [5.0, 7.0, 8.0, 2.0],
     [5.0, 5.0, 5.0, 5.0]),
]


async def settle(rt, timeout: float = 10.0) -> None:
    """Wait until every consumer group has committed through its
    topics' heads: the hooks ran and the alerts they raised are
    persisted."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while any(rt.bus.group_lags().values()):
        assert loop.time() < deadline, rt.bus.group_lags()
        await asyncio.sleep(0.02)


async def _alerts_for(pkg):
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="geo", **pkg.settings))
    for name in ("DeviceManagementService", "EventSourcesService",
                 "InboundProcessingService", "EventManagementService",
                 "DeviceStateService", "RuleProcessingService"):
        rt.add_service(getattr(pkg.services, name)(rt))
    await rt.start()
    try:
        await rt.add_tenant(pkg.config.TenantConfig(
            tenant_id="acme", sections={"rule-processing": {
                "model": "zscore", "model_config": {"window": 8},
                "buckets": [64], "batch_window_ms": 1.0,
                "geofences": [
                    {"zone": "dock", "alert_on": "both", "level": "error"},
                    {"zone": "ell", "alert_on": "enter"},
                    {"zone": "missing"}]}}))
        dm = rt.api("device-management").management("acme")
        dm.bootstrap_fleet(pkg.model.DeviceType(token="t", name="T"), 4)
        dm.create_zone(pkg.model.Zone(token="dock", name="Dock",
                                      bounds=SQUARE))
        dm.create_zone(pkg.model.Zone(token="ell", name="Ell", bounds=ELL))
        em = rt.api("event-management").management("acme")
        topic = rt.naming.tenant_topic("acme", "outbound-enriched-events")
        for dev, lat, lon, ts in STEPS:
            await rt.bus.produce(topic, pkg.batch.LocationBatch(
                pkg.batch.BatchContext(tenant_id="acme", source="test"),
                np.asarray(dev, np.uint32), np.asarray(lat, np.float64),
                np.asarray(lon, np.float64), np.zeros(len(dev), np.float32),
                np.asarray(ts, np.float64)))
            await settle(rt)
        return [(dm.get_device(a.device_id).index, a.type, a.level.name,
                 a.message) for a in em.list_alerts(limit=1000)]
    finally:
        await rt.stop()


def test_transition_alerts_equal(run):
    """The same location sequence (enter, dwell, a batch reporting one
    device twice, exit, re-enter; one fence per alert_on mode and one on
    a zone that does not exist) gives the same alerts in both
    packages."""
    async def main():
        return await _alerts_for(JAX), await _alerts_for(PORT)

    jax_alerts, port_alerts = run(main())
    assert port_alerts == jax_alerts
    kinds = {a[1] for a in port_alerts}
    assert kinds == {"zone.enter", "zone.exit"}
    assert len(port_alerts) >= 6
