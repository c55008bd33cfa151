"""The whole scored pipeline on both packages: the JAX package's six-service
runtime and the port's, on the CPU, driven by the same driver (the
pattern of tests/test_megabatch.py's `_drive_tenants`): 4 tenants × 32
devices × 10 ticks, 5% anomalies at 15 sigma, the same simulator seeds,
the same weights swapped in through each side's `swap_model_params` (the
port's through `convert.py`).

Compared per tenant: the scored (device, ts) key sets (equal); the
scores (atol 1e-2 plus 1e-3 relative, float16 readback on both sides);
`is_anomaly` and the alert sets (equal, except for events whose score
lies within that tolerance of the threshold); telemetry totals and the
inbound group's committed offsets (equal); device-state `last_seen`
(equal). Cases: zscore with megabatch on and off, `lstm-stream` through
the pool (window 8, hidden 8), `lstm` through a dedicated session
(hidden 8). The JAX side runs its scorers as its own tests do on the CPU.
"""

import asyncio
import importlib
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.convert import params_from_numpy
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

TENANTS = ("t0", "t1", "t2", "t3")
N_DEV, TICKS = 32, 10
ATOL, RTOL = 1e-2, 1e-3

CASES = {
    "zscore-megabatch": {"model": "zscore", "model_config": {"window": 16},
                         "megabatch": {"enabled": True}, "threshold": 6.0},
    "zscore-dedicated": {"model": "zscore", "model_config": {"window": 16},
                         "megabatch": {"enabled": False}, "threshold": 6.0},
    "lstm-stream-pool": {"model": "lstm-stream",
                         "model_config": {"window": 8, "hidden": 8},
                         "megabatch": {"enabled": True}, "threshold": 6.0},
    # the windowed model over 10 ticks of history scores spikes lower:
    # a lower bar keeps alerts in the comparison
    "lstm-dedicated": {"model": "lstm",
                       "model_config": {"window": 8, "hidden": 8},
                       "megabatch": {"enabled": False}, "threshold": 1.5},
}


def _package(root: str) -> SimpleNamespace:
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        config=mod("config"), service=mod("kernel.service"),
        services=mod("services"), model=mod("domain.model"),
        bus=mod("kernel.bus"), sim=mod("sim.simulator"),
        clients=mod("sim.clients"))


JAX_PKG, PORT_PKG = _package("sitewhere_tpu"), _package("sitewhere_tpu_torch")


def _weights(case: str) -> dict:
    """Per-tenant numpy weights, from the JAX model's own init."""
    from sitewhere_tpu.models import build_model

    rule = CASES[case]
    model = build_model(rule["model"], **rule["model_config"])
    return {tid: jax.tree.map(np.asarray,
                              model.init(jax.random.PRNGKey(10 + i)))
            for i, tid in enumerate(TENANTS)}


async def _drive(pkg, case: str, weights: dict, port: bool,
                 protocol: str = None, settings: dict = None,
                 rule_extra: dict = None) -> dict:
    """One package's six-service runtime through the case; returns
    {tenant: observables} once everything drained and committed. The
    ticks go through each tenant's in-proc queue receiver, or with
    `protocol` ("mqtt", "amqp", ...) through a receiver of that kind,
    sent by the package's own `sim.clients` sender (one connection and
    one topic a tenant, so each tenant's stream stays ordered).
    `settings` adds instance settings, `rule_extra` rule-processing
    keys."""
    extra = {"device": "cpu", **(settings or {})} if port else {}
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id=f"parity-{case}", **extra))
    s = pkg.services
    for cls in (s.DeviceManagementService, s.EventSourcesService,
                s.InboundProcessingService, s.EventManagementService,
                s.DeviceStateService, s.RuleProcessingService):
        rt.add_service(cls(rt))
    await rt.start()
    try:
        rule = {**CASES[case],
                "batch_window_ms": 1.0, "buckets": [256], "capacity": 256,
                **(rule_extra or {})}
        sections = {"rule-processing": rule}
        if protocol is not None:
            sections["event-sources"] = {"receivers": [
                {"kind": protocol, "decoder": "swb1", "name": protocol}]}
        for tid in TENANTS:
            await rt.add_tenant(pkg.config.TenantConfig(
                tenant_id=tid, sections=sections))
            rt.api("device-management").management(tid).bootstrap_fleet(
                pkg.model.DeviceType(token="thermo", name="T"), N_DEV)
        for tid in TENANTS:
            eng = rt.api("rule-processing").engine(tid)
            sink = eng.session or eng.pool_slot
            await wait_until(lambda s=sink: s.ready, timeout=60.0)
            params = weights[tid]
            eng.swap_model_params(params_from_numpy(params, "cpu")
                                  if port else params)
        consumers = {tid: rt.bus.subscribe(
            rt.naming.tenant_topic(tid, pkg.bus.TopicNaming.SCORED_EVENTS),
            group="parity-meter") for tid in TENANTS}
        sims = {tid: pkg.sim.DeviceSimulator(pkg.sim.SimConfig(
            num_devices=N_DEV, seed=100 + i, anomaly_rate=0.05,
            anomaly_magnitude=15.0), tenant_id=tid)
            for i, tid in enumerate(TENANTS)}
        receivers = {tid: rt.api("event-sources").engine(tid)
                     .receiver(protocol or "default") for tid in TENANTS}
        senders = {}
        if protocol is not None:
            topic = {"mqtt": "topic", "amqp": "routing_key",
                     "stomp": "destination", "coap": "path"}.get(protocol)
            for tid in TENANTS:
                kw = {topic: f"telemetry/{tid}"} if topic else {}
                senders[tid] = pkg.clients.make_sender(
                    protocol, "127.0.0.1", receivers[tid].port, **kw)
                await asyncio.wait_for(senders[tid].connect(), 10.0)
        last_ts = 1000.0 + 60.0 * (TICKS - 1)
        for k in range(TICKS):
            for tid in TENANTS:
                payload, _ = sims[tid].payload(t=1000.0 + 60.0 * k)
                if protocol is None:
                    assert await receivers[tid].submit(payload)
                else:
                    await asyncio.wait_for(senders[tid].send(payload), 10.0)
        for sender in senders.values():
            await asyncio.wait_for(sender.close(), 10.0)
        expected = N_DEV * TICKS
        out = {}
        for tid in TENANTS:
            em = rt.api("event-management").management(tid)
            await wait_until(
                lambda em=em: em.telemetry.total_events >= expected,
                timeout=60.0)
            scored: dict = {}

            def collect(c=consumers[tid], scored=scored):
                for r in c.poll_nowait(max_records=512):
                    b = r.value
                    for i in range(len(b)):
                        key = (int(b.device_index[i]), float(b.ts[i]))
                        assert key not in scored, f"{key} scored twice"
                        scored[key] = (float(b.score[i]),
                                       bool(b.is_anomaly[i]))
                return len(scored) >= expected

            await wait_until(collect, timeout=60.0)
            consumers[tid].close()
            state = rt.api("device-state").state(tid)
            await wait_until(
                lambda st=state: all(st.get_state(d)["last_seen"] == last_ts
                                     for d in range(N_DEV)), timeout=60.0)
            dm = rt.api("device-management").management(tid)
            alerts = {(dm.get_device(a.device_id).token, float(a.event_date),
                       a.type) for a in em.spi.alerts}
            decoded = rt.naming.tenant_topic(
                tid, pkg.bus.TopicNaming.EVENT_SOURCE_DECODED)
            end_total = sum(rt.bus.end_offsets(decoded))

            def committed(group=f"{tid}.inbound-processing", decoded=decoded,
                          end_total=end_total):
                return end_total - rt.bus.group_lags()[group].get(decoded, 0)

            await wait_until(lambda c=committed, e=end_total: c() >= e,
                             timeout=60.0)
            out[tid] = {
                "scored": scored, "alerts": alerts,
                "total": em.telemetry.total_events, "committed": committed(),
                "last_seen": [state.get_state(d)["last_seen"]
                              for d in range(N_DEV)],
            }
        return out
    finally:
        await rt.stop()


def assert_same_pipeline(case: str, want: dict, got: dict) -> None:
    bar = CASES[case]["threshold"]
    for tid in TENANTS:
        w, g = want[tid], got[tid]
        assert set(g["scored"]) == set(w["scored"])
        keys = sorted(w["scored"])
        ws = np.array([w["scored"][k][0] for k in keys])
        gs = np.array([g["scored"][k][0] for k in keys])
        np.testing.assert_allclose(gs, ws, atol=ATOL, rtol=RTOL)
        # a decision may flip only where the score sits at the bar
        edge = {k for k, v in w["scored"].items()
                if abs(v[0] - bar) <= ATOL + RTOL * bar}
        flips = {k for k in keys
                 if w["scored"][k][1] != g["scored"][k][1]}
        assert flips <= edge, sorted(flips - edge)
        edge_alerts = {(f"dev-{d}", ts) for d, ts in edge}
        assert {(tok, ts) for tok, ts, _ in
                g["alerts"] ^ w["alerts"]} <= edge_alerts
        assert g["total"] == w["total"] == N_DEV * TICKS
        assert g["committed"] == w["committed"]
        assert g["last_seen"] == w["last_seen"]


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_jax_pipeline(run, case):
    weights = _weights(case)
    want = run(_drive(JAX_PKG, case, weights, port=False))
    got = run(_drive(PORT_PKG, case, weights, port=True))
    assert_same_pipeline(case, want, got)
