"""The port's fleet observability plane (`sitewhere_tpu_torch/fleet/
observer.py`, the telemetry export of `kernel/observe.py`) on the cases
of `tests/test_fleet_observe.py` that the other port tests do not cover
(`TelemetryHistory` is held to the reference in
`tests/test_torch_durable.py`; the TRC01 lint case waits for the port's
swxlint, ROADMAP A.6):

- broker self-stats (`EventBus.stats()` and the `bus_stats` wire op);
- telemetry export and fold: each worker's beat publishes onto the
  instance telemetry topic and the `FleetObserver` merges the fleet
  critical path, lag matrix and mesh occupancy; a late observer rebuilds
  the view from topic replay;
- fleet-level observe on/off scored-output equivalence;
- `render_top`'s fleet scope and `render_fleet_top`, equal to the JAX
  package's text on the same reports;
- cross-worker trace continuity over two real port worker processes
  (marked `slow`, as its reference is).

Workers score on the CPU (`InstanceSettings.device="cpu"`). Every wait
has its own deadline.
"""


import asyncio
import contextlib
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.cli import render_fleet_top, render_top
from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
from sitewhere_tpu_torch.fleet import AutoscalerPolicy, FleetController
from sitewhere_tpu_torch.kernel.service import ServiceRuntime
from sitewhere_tpu_torch.services import EventSourcesService
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

from tests.test_torch_fleet import (
    DEVICES,
    RP_SECTION,
    _seed_registries,
    _worker_runtime,
)
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# broker self-stats
# ---------------------------------------------------------------------------


def test_bus_stats_unit_and_wire_op(run):
    async def main():
        from sitewhere_tpu_torch.kernel.bus import EventBus
        from sitewhere_tpu_torch.kernel.wire import BusServer, RemoteEventBus

        bus = EventBus(default_partitions=2)
        await bus.produce("swx1.tenant.t0.scored-events", {"n": 1},
                          key="a")
        consumer = bus.subscribe("swx1.tenant.t0.scored-events",
                                 group="t0.meter")
        stats = bus.stats()
        topic = stats["topics"]["swx1.tenant.t0.scored-events"]
        assert topic["partitions"] == 2 and topic["depth"] == 1
        assert stats["groups"]["t0.meter"]["members"] == 1
        assert stats["groups"]["t0.meter"]["lag"] == 1
        assert stats["fence_rejections"] == 0
        assert stats["members_evicted"] == 0
        # over the wire: same dict through the bus_stats op
        server = BusServer(bus)
        await server.start()
        remote = RemoteEventBus("127.0.0.1", server.port)
        await remote.initialize()
        wired = await remote.bus_stats()
        assert wired["groups"]["t0.meter"]["lag"] == 1
        assert set(wired) == set(stats)
        consumer.close()
        await remote.stop()
        await server.stop()

    run(main())


# ---------------------------------------------------------------------------
# in-proc fleet harness with observability knobs
# ---------------------------------------------------------------------------


@contextlib.asynccontextmanager
async def observed_fleet(tmp_path, *, observe=True, n_workers=2,
                         n_tenants=2, megabatch=True, history=False,
                         worker_overrides=None):
    """The test_fleet in-proc topology (N fleet_managed runtimes + a
    driver hosting ingress/controller on ONE bus) with the observe
    levers parameterized: worker beats export onto the telemetry topic
    (fleet_managed → auto), the driver's controller hosts the
    FleetObserver, and `history=True` gives the driver a durable
    telemetry tier."""
    rp = dict(RP_SECTION)
    if megabatch:
        rp["megabatch"] = {"enabled": True}
    cfgs = [TenantConfig(tenant_id=f"t{i}",
                         sections={"rule-processing": rp})
            for i in range(n_tenants)]
    driver = ServiceRuntime(InstanceSettings(
        instance_id="fleet-test", fleet_interval_s=0.05,
        fleet_dead_after_s=1.5, rest_port=0, observe_enabled=observe,
        observe_interval_ms=50.0, trace_sample=1,
        observe_export_stages_every=2,
        data_dir=(str(tmp_path / "driver-data") if history else None)))
    driver.add_service(EventSourcesService(driver))
    controller = FleetController(
        driver, policy=AutoscalerPolicy(min_workers=n_workers,
                                        max_workers=n_workers))
    driver.add_child(controller)
    await driver.start()
    await _seed_registries(driver.bus, cfgs)
    runtimes, workers = {}, {}
    for i in range(n_workers):
        wid = f"w{i}"
        rt, worker = _worker_runtime(bus=driver.bus, wid=wid,
                                     data_dir=tmp_path,
                                     observe_enabled=observe,
                                     trace_sample=1,
                                     observe_export_stages_every=2,
                                     **(worker_overrides or {}))
        await rt.start()
        runtimes[wid] = rt
        workers[wid] = worker
    for cfg in cfgs:
        await driver.add_tenant(cfg)
    await wait_until(lambda: controller.snapshot()["converged"],
                     timeout=120.0)
    try:
        yield driver, controller, runtimes, workers, cfgs
    finally:
        for rt in runtimes.values():
            if rt.status.value != "stopped":
                await rt.stop()
        await driver.stop()


async def _score_rounds(driver, cfgs, rounds=3):
    """Submit `rounds` payloads per tenant; return per-tenant scored
    value arrays once everything came back."""
    consumers = {c.tenant_id: driver.bus.subscribe(
        driver.naming.tenant_topic(c.tenant_id, "scored-events"),
        group="observe-meter") for c in cfgs}
    scores = {c.tenant_id: [] for c in cfgs}
    sims = {c.tenant_id: DeviceSimulator(
        SimConfig(num_devices=DEVICES), tenant_id=c.tenant_id)
        for c in cfgs}
    for k in range(rounds):
        for tid, sim in sims.items():
            receiver = driver.api("event-sources").engine(tid) \
                .receiver("default")
            assert await receiver.submit(sim.payload(t=1000.0 + k)[0])

    def caught_up():
        for tid, consumer in consumers.items():
            for record in consumer.poll_nowait(max_records=128):
                scores[tid].append(np.asarray(record.value.score))
        return all(sum(len(s) for s in scores[t]) >= rounds * DEVICES
                   for t in scores)

    await wait_until(caught_up, timeout=90.0)
    for consumer in consumers.values():
        consumer.close()
    return {tid: np.sort(np.concatenate(arrs))
            for tid, arrs in scores.items()}


# ---------------------------------------------------------------------------
# telemetry export + fleet observer
# ---------------------------------------------------------------------------


def test_telemetry_export_and_fleet_observer(run, tmp_path):
    async def main():
        async with observed_fleet(tmp_path, history=True) as (
                driver, controller, runtimes, workers, cfgs):
            observer = controller.observer
            assert observer is driver.fleet_observer
            await _score_rounds(driver, cfgs)
            # both workers' beats folded (and the export counters move
            # worker-side)
            await wait_until(lambda: {"w0", "w1"} <= set(
                observer.workers), timeout=30.0)
            for rt in runtimes.values():
                assert rt.metrics.counter("observe.exports").value > 0
            # stage exports merge into ONE fleet critical path that
            # contains WORKER-side spine stages the driver never ran
            await wait_until(lambda: "rule-processing.score" in
                             observer.snapshot()["critical_path"]["stages"],
                             timeout=30.0)
            snap = observer.snapshot()
            stages = snap["critical_path"]["stages"]
            assert {"event-sources.receive", "event-sources.decode"} \
                <= set(stages)  # driver's own export joins the merge
            assert {"rule-processing.dispatch", "rule-processing.score",
                    "egress.publish"} <= set(stages)
            assert snap["critical_path"]["workers_merged"] >= 3
            # worker rows carry beat/liveness + mesh occupancy (the
            # megabatch pool reports per-device telemetry)
            w0 = snap["workers"]["w0"]
            assert w0["beats"] > 0 and w0["beat_age_s"] < 5.0
            meshes = [b for w in snap["workers"].values()
                      for b in w["mesh"]]
            assert meshes, "megabatch pools must report mesh stats"
            assert {"row_occupancy", "model_tflops_per_device",
                    "window_ms_live"} <= set(meshes[0])
            # lag matrix rows attribute tenants to their owners
            owners = controller.snapshot()["owners"]
            for tid, row in snap["lag_matrix"].items():
                if tid in owners:
                    assert row["worker"] == owners[tid]
            # broker stats ride along (the black-box closer)
            assert snap["broker"]["groups"], snap["broker"]
            assert "fence_rejections" in snap["broker"]
            # the driver's durable history holds the per-tenant lag
            # series the observer appends each tick
            assert ("t0", "lag") in driver.history.series()
            # fleet-merged prometheus exposition renders per-worker and
            # per-stage labeled gauges
            prom = observer.prometheus_text()
            assert 'swx_fleet_worker_loop_lag_ms{worker="w0"}' in prom
            assert 'stage="rule-processing.score"' in prom

    run(main())


def test_observer_rebuilds_from_topic_replay(run, tmp_path):
    """A restarted controller host (or a late-started observer) must
    rebuild every worker's last-known beat + stage export from the
    RETAINED telemetry stream — and keep tracking a worker across its
    own restart (fresh runtime, same id)."""
    async def main():
        from sitewhere_tpu_torch.fleet.observer import FleetObserver

        async with observed_fleet(tmp_path) as (
                driver, controller, runtimes, workers, cfgs):
            observer = controller.observer
            await _score_rounds(driver, cfgs)
            await wait_until(lambda: {"w0", "w1"} <= set(
                observer.workers), timeout=30.0)
            # a SECOND observer starting late — beats already flowed —
            # rebuilds the same per-worker view from topic replay alone
            peer = ServiceRuntime(InstanceSettings(
                instance_id="fleet-test", observe_enabled=False),
                bus=driver.bus)
            late = FleetObserver(peer)
            peer.add_child(late)
            await peer.start()
            await wait_until(lambda: {"w0", "w1"} <= set(late.workers),
                             timeout=30.0)
            assert late.workers["w0"]["sample"] is not None
            await peer.stop()
            # worker restart: a FRESH runtime under the same id keeps
            # exporting; the observer's view refreshes (age resets,
            # beats keep arriving) instead of going stale
            rt0 = runtimes.pop("w0")
            workers.pop("w0")
            await rt0.stop()
            await asyncio.sleep(0.3)
            rt0b, w0b = _worker_runtime(bus=driver.bus, wid="w0",
                                        data_dir=tmp_path / "restart")
            await rt0b.start()
            runtimes["w0"] = rt0b
            workers["w0"] = w0b
            t_restart = time.monotonic()
            await wait_until(
                lambda: observer.workers.get("w0", {}).get(
                    "received_at", 0) > t_restart, timeout=30.0)
            assert observer.snapshot()["workers"]["w0"]["beat_age_s"] < 5.0

    run(main())


def test_fleet_observe_on_off_scored_equivalence(run, tmp_path):
    """The fleet observability plane is an observer: telemetry export,
    the FleetObserver, and history appends must not change a single
    scored output at the fleet level."""
    async def scores_with(observe, subdir):
        async with observed_fleet(tmp_path / subdir,
                                  observe=observe) as (
                driver, controller, runtimes, workers, cfgs):
            if observe:
                await wait_until(lambda: {"w0", "w1"} <= set(
                    controller.observer.workers), timeout=30.0)
            else:
                assert controller.observer is None
                for rt in runtimes.values():
                    assert rt.beat is None
            return await _score_rounds(driver, cfgs)

    async def main():
        on = await scores_with(True, "on")
        off = await scores_with(False, "off")
        assert set(on) == set(off)
        for tid in on:
            assert on[tid].shape == off[tid].shape
            np.testing.assert_allclose(on[tid], off[tid], rtol=1e-6)

    run(main())


# ---------------------------------------------------------------------------
# operator surfaces
# ---------------------------------------------------------------------------


def test_render_top_states_fleet_scope():
    report = {"critical_path": {"stages": {}, "sample": 64,
                                "span_count": 0},
              "beat": None,
              "fleet": {"epoch": 3, "workers": {
                  "w0": {"ready": True, "owned": ["t0"]},
                  "w1": {"ready": True, "owned": ["t1"]}}}}
    out = render_top(report)
    from sitewhere_tpu.cli import render_top as jax_render_top

    assert out == jax_render_top(report)
    assert "LOCAL runtime only" in out
    assert "swx top --fleet" in out
    # a fleet-less runtime keeps the old screen (no scope noise)
    solo = render_top({"critical_path": {"stages": {}, "sample": 64,
                                         "span_count": 0}, "beat": None})
    assert "LOCAL runtime only" not in solo


def test_render_fleet_top():
    report = {
        "workers": {"w0": {
            "beat_age_s": 0.2, "seq": 9, "beats": 42,
            "loop_lag_ms": 1.5, "loop_lag_p99_ms": 3.0,
            "loop_stalls": 1, "consumer_lag_max": 17,
            "egress_backlog": 2, "scoring_pending": 5,
            "scoring_inflight": 1, "flow_modes": {"t0": "ok"},
            "mesh": [{"model": "zscore", "devices": 8,
                      "tenant_rows": 3, "row_capacity": 4,
                      "row_occupancy": 0.75, "window_ms_live": 1.5,
                      "model_tflops_per_device": 0.00123}]}},
        "critical_path": {"stages": {
            "wire.poll": {"kind": "queue", "count": 4, "p50_ms": 0.2,
                          "p95_ms": 0.8, "p99_ms": 1.0},
            "rule-processing.score": {"kind": "service", "count": 4,
                                      "p50_ms": 1.0, "p95_ms": 2.0,
                                      "p99_ms": 2.5}},
            "span_count": 8, "workers_merged": 2,
            "queue_wait_p99_ms": 1.0, "service_p99_ms": 2.5},
        "lag_matrix": {"t0": {"lag": 12, "worker": "w0"}},
        "mesh": {"w0": [{"model": "zscore", "devices": 8,
                         "tenant_rows": 3, "row_capacity": 4,
                         "row_occupancy": 0.75, "window_ms_live": 1.5,
                         "model_tflops_per_device": 0.00123}]},
        "telemetry": {"topic": "x.instance.telemetry", "records": 99,
                      "observer_lag": 0},
        "broker": {"topics": {"a": {}}, "groups": {
            "t0.inbound-processing": {"members": 1, "lag": 12,
                                      "generation": 1}},
            "fence_rejections": 1, "members_evicted": 2},
        "history": {"series": 3, "windows": 40, "segments": 1,
                    "window_s": 10.0},
    }
    out = render_fleet_top(report)
    from sitewhere_tpu.cli import render_fleet_top as jax_render_fleet_top

    assert out == jax_render_fleet_top(report)
    assert "wire.poll" in out and "queue" in out
    assert "w0" in out and "42" in out
    assert "t0" in out and "12" in out
    assert "0.00123" in out
    assert "fence-rejections 1" in out
    assert "members-evicted 2" in out
    assert "history: 3 series" in out


# ---------------------------------------------------------------------------
# cross-worker trace continuity over REAL processes (the tier1 smoke)
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_cross_worker_trace_continuity(tmp_path):
    """A single injected device event produces ONE trace whose spine
    crosses ≥2 REAL OS processes over the wire bus: receive/decode on
    the ingress host, wire.poll/enrich/persist/dispatch/score/publish
    (+ the worker's own wire.produce hops) on its tenant's owner
    worker — ≥7 spine stages under one origin-scoped trace id, stitched
    via the worker ApiServer `trace` op and visible in the
    FleetObserver's merged fleet critical path. Run by scripts/tier1.sh
    as the fleet-observe smoke (marked slow: two jax-bearing worker
    processes).

    Here the two workers are the port's (`sitewhere_tpu_torch.fleet.
    worker_main`, scoring on the CPU). It is marked `slow` only because
    its reference, `tests/test_fleet_observe.py::
    test_cross_worker_trace_continuity`, is."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    async def main():
        from sitewhere_tpu_torch.kernel.bus import EventBus
        from sitewhere_tpu_torch.kernel.wire import ApiChannel, BusServer

        n_workers = 2
        tenant_ids = [f"t{i}" for i in range(4)]
        bus = EventBus(default_partitions=4, retention=65536)
        driver = ServiceRuntime(InstanceSettings(
            instance_id="fleet-obs", bus_retention=65536,
            trace_sample=1, observe_interval_ms=100.0,
            fleet_interval_s=0.25, fleet_dead_after_s=8.0,
            flow_degrade_at=10.0, flow_defer_at=10.0), bus=bus)
        driver.add_service(EventSourcesService(driver))
        controller = FleetController(
            driver, policy=AutoscalerPolicy(min_workers=n_workers,
                                            max_workers=n_workers,
                                            scale_up_lag=1e18,
                                            imbalance_ratio=1e18))
        driver.add_child(controller)
        cfgs = [TenantConfig(tenant_id=tid, sections={
            "rule-processing": dict(RP_SECTION)}) for tid in tenant_ids]
        await driver.start()
        await _seed_registries(bus, cfgs, instance_id="fleet-obs")
        broker = BusServer(bus)
        await broker.start()

        procs = {}
        api_ports = {}
        try:
            for i in range(n_workers):
                wid = f"w{i}"
                api_ports[wid] = _free_port()
                cfg = {
                    "worker_id": wid, "host": "127.0.0.1",
                    "port": broker.port, "instance_id": "fleet-obs",
                    "force_cpu": True,
                    "api_port": api_ports[wid], "log_level": "WARNING",
                    "settings": {
                        "trace_sample": 1,
                        "observe_interval_ms": 100.0,
                        "observe_export_stages_every": 2,
                        "fleet_heartbeat_s": 0.25,
                        "flow_degrade_at": 10.0, "flow_defer_at": 10.0,
                        "data_dir": str(tmp_path / wid),
                    },
                }
                env = dict(os.environ)
                env["OMP_NUM_THREADS"] = "2"
                env["PYTHONPATH"] = repo + os.pathsep \
                    + env.get("PYTHONPATH", "")
                import json as _json
                procs[wid] = subprocess.Popen(
                    [sys.executable, "-m",
                     "sitewhere_tpu_torch.fleet.worker_main",
                     _json.dumps(cfg)],
                    stdout=subprocess.DEVNULL, env=env, cwd=repo)
            for cfg in cfgs:
                await driver.add_tenant(cfg)
            t0 = time.monotonic()
            while True:
                snap = controller.snapshot()
                if snap["converged"] and len(snap["workers"]) \
                        >= n_workers:
                    break
                dead = [w for w, p in procs.items()
                        if p.poll() is not None]
                assert not dead, f"worker(s) died during startup: {dead}"
                assert time.monotonic() - t0 < 180.0, \
                    f"fleet did not converge: {snap['workers']}"
                await asyncio.sleep(0.25)
            owners = controller.snapshot()["owners"]
            assert len(set(owners.values())) >= 2, (
                f"placement put every tenant on one worker: {owners}")

            # one scored round per tenant, metered off the shared bus
            meters = {tid: bus.subscribe(
                driver.naming.tenant_topic(tid, "scored-events"),
                group="trace-meter") for tid in tenant_ids}
            sims = {tid: DeviceSimulator(
                SimConfig(num_devices=DEVICES), tenant_id=tid)
                for tid in tenant_ids}
            scored = {tid: 0 for tid in tenant_ids}
            for tid in tenant_ids:
                receiver = driver.api("event-sources").engine(tid) \
                    .receiver("default")
                assert await receiver.submit(
                    sims[tid].payload(t=1000.0)[0])

            def caught_up():
                for tid, consumer in meters.items():
                    for record in consumer.poll_nowait(max_records=64):
                        scored[tid] += len(record.value)
                return all(scored[t] >= DEVICES for t in tenant_ids)

            await wait_until(caught_up, timeout=120.0)

            # ONE trace id from the ingress host's receive span …
            victim = tenant_ids[0]
            owner = owners[victim]
            receive = [s for s in driver.tracer.spans(
                stage="event-sources.receive", tenant=victim, limit=-1)]
            assert receive, "ingress host recorded no receive span"
            trace_id = receive[-1].trace_id
            driver_spans = driver.tracer.trace(trace_id)

            # … stitched with the owner worker's spans via the wire
            # trace op (retry: the worker records spans as it settles)
            channel = ApiChannel("127.0.0.1", api_ports[owner])
            worker_spans = []
            deadline = time.monotonic() + 60.0
            want = {"rule-processing.score", "egress.publish"}
            while time.monotonic() < deadline:
                worker_spans = await channel.trace(trace_id)
                if want <= {s["stage"] for s in worker_spans}:
                    break
                await asyncio.sleep(0.5)
            channel.close()

            driver_stages = {s.stage for s in driver_spans}
            worker_stages = {s["stage"] for s in worker_spans}
            assert {"event-sources.receive",
                    "event-sources.decode"} <= driver_stages
            # the broker hop is no longer dark: the worker polled the
            # record over the wire and produced its downstream hops
            # over the wire
            assert "wire.poll" in worker_stages, worker_stages
            assert "wire.produce" in worker_stages, worker_stages
            assert {"inbound.enrich", "event-management.persist",
                    "rule-processing.dispatch", "rule-processing.score",
                    "egress.publish"} <= worker_stages, worker_stages
            spine = driver_stages | worker_stages
            assert len(spine & {
                "event-sources.receive", "event-sources.decode",
                "wire.poll", "wire.produce", "inbound.enrich",
                "event-management.persist", "rule-processing.dispatch",
                "rule-processing.score", "egress.publish"}) >= 7
            # every stitched span carries the ONE origin-scoped id
            assert all(s.trace_id == trace_id for s in driver_spans)
            assert all(s["trace_id"] == trace_id for s in worker_spans)

            # and the fleet observer's merged critical path covers the
            # worker-side stages the driver never ran (the
            # `swx top --fleet` data source)
            observer = controller.observer
            await wait_until(
                lambda: "rule-processing.score" in
                observer.snapshot()["critical_path"]["stages"],
                timeout=60.0)
            merged = observer.snapshot()["critical_path"]["stages"]
            assert "wire.poll" in merged
            for consumer in meters.values():
                consumer.close()
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.terminate()
            for proc in procs.values():
                try:
                    proc.wait(timeout=20.0)
                except subprocess.TimeoutExpired:
                    proc.kill()
            await broker.stop()
            await driver.stop()

    asyncio.run(main())
