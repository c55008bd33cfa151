"""Fleet worker process entry: `python -m sitewhere_tpu_torch.fleet.worker_main
'<json-config>'` (or `swx fleet-worker`, cli.py).

The config is one JSON object:

    {"worker_id": "w0", "host": "127.0.0.1", "port": 47900,
     "instance_id": "swx1",            # MUST match the broker's naming
     "force_cpu": false,               # score on the CPU, not the card
     "secret": null,                   # wire-auth shared secret
     "settings": {...},                # InstanceSettings overrides
     "chaos": {"seed": 0,              # optional fault injection
               "sites": {"fleet.heartbeat": {"rate": 0.5,
                                             "max_faults": 1}}}}

Builds a `fleet_managed` ServiceRuntime over a `RemoteEventBus` with the
scoring-pipeline services (the colocation set the split topology
proved: device-mgmt, inbound, event-mgmt, device-state,
rule-processing), attaches a `FleetWorker`, and runs until SIGTERM/
SIGINT or until the controller retires the worker.

Hermetic by default: tenant registry state replicates over the bus
(the per-tenant registry-state topic, services/replication.py), so a
worker needs NOTHING but the wire broker to adopt a tenant — no shared
filesystem. A `data_dir`, when given, is worker-LOCAL (registry WAL +
snapshots for single-node restart; event-history spill), never shared.
Every data-path produce/commit carries the placement epoch fencing
token; a worker whose writes are rejected (it was declared dead while
stalled) stops the tenant's engines instead of retrying
(docs/FLEET.md fencing protocol).

Rule-processing scores on the CUDA card unless `force_cpu` names the
CPU (`InstanceSettings.device`); without a card and without it, the
worker fails at start (no probe, no fallback). The worker finds its
kernels already built under `build/torch_kernels/` when a parent built
them (or builds them at first use). With `api_port`, its `ApiServer`
also answers a `stats` op: the runtime's scoring dispatches, this
process's K1 launches and the tenants it owns.
"""

from __future__ import annotations

import asyncio
import json
import signal
import sys


def build_runtime(cfg: dict):
    """Worker runtime from a config dict (bench + CLI entry share it)."""
    from sitewhere_tpu_torch.config import InstanceSettings
    from sitewhere_tpu_torch.fleet.worker import FleetWorker
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.kernel.wire import RemoteEventBus
    from sitewhere_tpu_torch.services import (
        DeviceManagementService,
        DeviceStateService,
        EventManagementService,
        InboundProcessingService,
        RuleProcessingService,
    )

    overrides = dict(cfg.get("settings") or {})
    if cfg.get("force_cpu"):
        overrides["device"] = "cpu"
    settings = InstanceSettings(
        instance_id=cfg["instance_id"], fleet_managed=True, **overrides)
    # wire data-plane fast path (docs/PERFORMANCE.md): prefetch +
    # pipelined produce ride the same settings overlay as every other
    # knob, so the bench's A/B off leg is one `settings` key away
    bus = RemoteEventBus(cfg.get("host", "127.0.0.1"), cfg["port"],
                         secret=cfg.get("secret"),
                         prefetch=settings.wire_prefetch,
                         prefetch_credit=settings.wire_prefetch_credit,
                         pipeline=settings.wire_pipeline,
                         linger_ms=settings.wire_linger_ms,
                         inflight_cap=settings.wire_inflight_cap)
    # owner-tag every membership this worker registers: a controller
    # death declaration then evicts them broker-side, so a SIGSTOPped
    # zombie's partitions reassign instead of stalling until SIGCONT
    bus.owner = cfg["worker_id"]
    rt = ServiceRuntime(settings, bus=bus)
    for cls in (DeviceManagementService, InboundProcessingService,
                EventManagementService, DeviceStateService,
                RuleProcessingService):
        rt.add_service(cls(rt))
    worker = FleetWorker(rt, cfg["worker_id"])
    rt.add_child(worker)
    chaos = cfg.get("chaos")
    if chaos:
        from sitewhere_tpu_torch.kernel.faults import FaultInjector

        injector = FaultInjector(seed=int(chaos.get("seed", 0)))
        sites = chaos.get("sites") or {}
        # literal site names only (FLT01: the registry vouches for
        # literals) — the worker-side chaos surfaces are the heartbeat
        # loop and the replay-on-adopt path; bus.poll rides the broker
        # process, not this one
        spec = sites.get("fleet.heartbeat")
        if spec:
            injector.arm("fleet.heartbeat",
                         rate=float(spec.get("rate", 1.0)),
                         max_faults=int(spec.get("max_faults", -1)))
        spec = sites.get("fence.adopt")
        if spec:
            injector.arm("fence.adopt",
                         rate=float(spec.get("rate", 1.0)),
                         max_faults=int(spec.get("max_faults", -1)))
        rt.install_faults(injector)
    return rt, worker


def _stats_op(rt, worker):
    """The `stats` op: scoring dispatches (the runtime's counter), K1
    launches in this process (`ops.lstm_kernel.launches`, kernel launches
    only) and the tenants owned, read together."""
    from sitewhere_tpu_torch.ops import lstm_kernel

    dispatches = rt.metrics.counter("scoring.dispatches")

    async def op(msg, writer=None) -> dict:
        return {"worker": worker.worker_id,
                "dispatches": int(dispatches.value),
                "kernel_launches": lstm_kernel.launches,
                "owned": sorted(worker.owned)}
    return op


async def amain(cfg: dict) -> int:
    rt, worker = build_runtime(cfg)
    await rt.start()
    api = None
    if cfg.get("api_port") is not None:
        # per-worker control/query plane (kernel/wire.py ApiServer):
        # observe/trace/health ops for fleet tooling — the trace op is
        # how a cross-process trace is stitched (tests, tier1 smoke)
        from sitewhere_tpu_torch.kernel.wire import ApiServer

        api = ApiServer(rt, port=int(cfg["api_port"]),
                        secret=cfg.get("secret"))
        api.handlers["stats"] = _stats_op(rt, worker)
        await api.start()
        print(f"FLEET-WORKER {cfg['worker_id']} api-port {api.port}",
              flush=True)
    print(f"FLEET-WORKER {cfg['worker_id']} up", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover
            pass
    while not stop.is_set() and not worker.retired:
        try:
            await asyncio.wait_for(stop.wait(), timeout=0.25)
        except asyncio.TimeoutError:
            pass
    if worker.retired:
        print(f"FLEET-WORKER {cfg['worker_id']} retired", flush=True)
    if api is not None:
        await api.stop()
    await rt.stop()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m sitewhere_tpu_torch.fleet.worker_main "
              "'<json-config>'", file=sys.stderr)
        return 2
    cfg = json.loads(argv[0])
    import logging

    logging.basicConfig(
        level=getattr(logging, str(cfg.get("log_level", "INFO")).upper(),
                      logging.INFO),
        format=f"%(asctime)s [{cfg.get('worker_id', '?')}] "
               f"%(name)s %(levelname)s %(message)s")
    return asyncio.run(amain(cfg))


if __name__ == "__main__":
    sys.exit(main())
