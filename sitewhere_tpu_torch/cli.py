"""`python -m sitewhere_tpu_torch.cli` — the port's entry point.

    python -m sitewhere_tpu_torch.cli demo [--devices N] [--seconds S] [--cpu]

`demo` is the one command ported so far (the JAX package's `swx demo`):
one process hosts the scored pipeline's six services (device-management,
event-sources, inbound-processing, event-management, device-state,
rule-processing), adds a tenant with a zscore rule, streams a simulated
fleet with injected anomalies through the tenant's in-proc receiver for
`--seconds`, and prints one JSON report. The JAX demo hosts all fourteen
services and creates its tenant through instance-management; this one
adds it with `ServiceRuntime.add_tenant`, as the bench does. Scoring runs
on the CUDA card; `--cpu` names the CPU instead. Without `--cpu` and
with no card, it exits with "no CUDA device" — there is no probe and no
fallback. The other commands (`run`, `simulate`, `replay`, `dlq`,
`quota`, `top`, `fleet`) are ROADMAP A.1.5.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
from sitewhere_tpu_torch.utils.roadmap import not_ported

PIPELINE_SERVICES = ("DeviceManagementService", "EventSourcesService",
                     "InboundProcessingService", "EventManagementService",
                     "DeviceStateService", "RuleProcessingService")


def build_runtime(settings: InstanceSettings):
    """A `ServiceRuntime` hosting the scored pipeline's six services."""
    from sitewhere_tpu_torch import services
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime

    rt = ServiceRuntime(settings)
    for name in PIPELINE_SERVICES:
        rt.add_service(getattr(services, name)(rt))
    return rt


async def cmd_demo(args) -> int:
    """Self-contained demo: instance + fleet + anomalies, report alerts."""
    from sitewhere_tpu_torch.domain.model import DeviceType
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    if args.port:
        raise not_ported("the REST facade (--port)", "A.1.4")
    rt = build_runtime(InstanceSettings(
        instance_id="demo", device="cpu" if args.cpu else None))
    await rt.start()
    try:
        await rt.add_tenant(TenantConfig(
            tenant_id="demo", name="Demo", sections={"rule-processing": {
                "model": "zscore", "model_config": {"window": 32},
                "threshold": 5.0, "batch_window_ms": 2.0,
                "buckets": [args.devices]}}))
        dm = rt.api("device-management").management("demo")
        dm.bootstrap_fleet(DeviceType(token="thermo", name="Thermometer"),
                           args.devices)
        sim = DeviceSimulator(SimConfig(num_devices=args.devices,
                                        anomaly_rate=0.002,
                                        anomaly_magnitude=12.0),
                              tenant_id="demo")
        receiver = rt.api("event-sources").engine("demo").receiver("default")
        session = rt.api("rule-processing").engine("demo").session
        while not session.ready:
            await asyncio.sleep(0.05)
        print(f"demo: {args.devices} devices streaming for {args.seconds}s "
              f"on {session.device} ...", flush=True)
        t0 = time.monotonic()
        k = 0
        while time.monotonic() - t0 < args.seconds:
            # a payload flow control sheds at ingress is not sent
            if await receiver.submit(sim.payload(t=time.time())[0]):
                k += 1
            await asyncio.sleep(0.01)
        sent = k * args.devices
        em = rt.api("event-management").management("demo")
        # the tail drains through decode → persist → score: wait for it
        # (bounded) instead of a fixed pause
        deadline = time.monotonic() + 30.0
        while ((em.telemetry.total_events < sent or not session.idle)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        alerts = em.list_alerts()
        snap = rt.metrics.snapshot()
        print(json.dumps({
            "events_sent": sent,
            "events_persisted": em.telemetry.total_events,
            "model_alerts": len(alerts),
            "scoring_rate_10s": snap["scoring.events_scored"]["rate_10s"],
            "p99_ms": round(snap["scoring.e2e_latency_s"]["p99"] * 1e3, 2),
        }, indent=2), flush=True)
    finally:
        await rt.stop()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sitewhere_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_demo = sub.add_parser(
        "demo", help="one-process end-to-end demo: the six pipeline "
        "services, a tenant added with add_tenant (the JAX demo hosts "
        "fourteen and creates it through instance-management)")
    p_demo.add_argument("--devices", type=int, default=1000)
    p_demo.add_argument("--seconds", type=float, default=5.0)
    p_demo.add_argument("--port", type=int,
                        help="REST port (the REST facade is not ported)")
    p_demo.add_argument("--cpu", action="store_true",
                        help="score on the CPU instead of the CUDA card")
    args = parser.parse_args(argv)
    return asyncio.run({"demo": cmd_demo}[args.cmd](args))


if __name__ == "__main__":
    sys.exit(main())
