"""`python -m sitewhere_tpu_torch.cli` — the port's entry point.

    python -m sitewhere_tpu_torch.cli demo [--devices N] [--seconds S]
        [--port P] [--cpu]
    python -m sitewhere_tpu_torch.cli replay --data-dir D --tenant T [--cpu]
        [--candidate DIR [--candidate-version N] [--max-divergence X]]
    python -m sitewhere_tpu_torch.cli train [--model lstm] [--steps N]
        [--checkpoint DIR] [--cpu]
    python -m sitewhere_tpu_torch.cli simulate [--protocol P] [--port N]
        [--devices N] [--seconds S] [--rate R]
    python -m sitewhere_tpu_torch.cli run [--config YAML] [--port P]
        [--services a,b] [--bus H:P] [--remote SVC=H:P] [--api-port P]
        [--serve-bus-port P] [--kafka-port P] [--no-tenants] [--cpu]
    python -m sitewhere_tpu_torch.cli serve-bus [--host H] [--port P]
    python -m sitewhere_tpu_torch.cli dlq list|replay --port P [--tenant T]
    python -m sitewhere_tpu_torch.cli quota show|set --port P [--tenant T]
    python -m sitewhere_tpu_torch.cli top --port P [--once] [--json]
    python -m sitewhere_tpu_torch.cli fleet status --port P [--json]

`demo` (the JAX package's `swx demo`): one process hosts all fourteen
services (`ALL_SERVICES`, in the JAX start order) and serves the REST
facade on `--port` (port 0, a free one, when none is given); it creates
a tenant with a zscore rule through instance-management, streams a
simulated fleet with injected anomalies through the tenant's in-proc
receiver for `--seconds`, and prints one JSON report. Scoring runs on
the CUDA card; `--cpu` names the CPU instead. Without `--cpu` and with
no card, it exits with "no CUDA device" — there is no probe and no
fallback.

`replay` (the JAX package's `swx replay`): open one tenant's durable log
and cold tier under a stopped instance's `--data-dir`, compact the log
(the active segment included), and stream the time range through a
`SharedScoringPool` at full speed; prints the replay report as JSON. It
scores on the card, or on the CPU with `--cpu`, as `demo` does. With
`--candidate DIR` it loads a checkpoint of `--model` from DIR (the
tenant's, else the `cli` one `train` writes) and runs the shadow-scoring
gate (`ReplayEngine.guard_swap`) instead: it prints the divergence
report and exits 1 when the gate refuses promotion, 2 when there is no
checkpoint.

`train` (the JAX package's `swx train`): train `--model` over synthetic
windows (`--devices` series of `--history` points) for `--steps` Adam
steps on the card (`--cpu` names the CPU), print one JSON line, and with
`--checkpoint DIR` save the params under `DIR/cli/<model>/v<N>/`.
`--distributed` (multi-host training) is ROADMAP A.2.

`simulate` (the JAX package's `swx simulate`): stream a simulated
fleet's SWB1 ticks at one ingest endpoint over `--protocol` (tcp, mqtt,
coap, websocket, amqp or stomp; the clients of `sim/clients.py`) at
`--rate` batches a second for `--seconds`, and print `sent N events over
P (R/s)`. It only sends: it touches no device and takes no `--cpu`.

`run` (the JAX package's `swx run`): host every service (or the
`--services` subset of a process-split deployment) with the tenants of
`--config` (or a default tenant with a queue receiver and a TCP gateway
on `--gateway-port`), and serve REST until SIGINT/SIGTERM. `--bus H:P`
attaches to a `serve-bus` broker instead of an in-proc bus, `--remote
SVC=H:P` reaches a peer's service over the wire, `--api-port` serves
this process's services to such peers, `--serve-bus-port` serves the
in-proc bus to wire peers and `--kafka-port` over the Kafka protocol.
Rule-processing (and batch-operations) run on the CUDA card; `--cpu`
names the CPU, and without it a process hosting them on a machine with
no card fails at start. `--fleet-controller` hosts the fleet control
plane (placement, liveness, the autoscaler, the fleet observer) in this
process, the broker process of `fleet-worker` peers; pair it with
`--serve-bus-port`.

`serve-bus` (`swx serve-bus`): the broker process, an in-proc bus served
over the wire protocol (`kernel/wire.py`) and, with `--kafka-port`, over
the Kafka protocol. It touches no device.

`dlq`, `quota`, `top` and `fleet` (`swx dlq`, `swx quota`, `swx top`,
`swx fleet`): REST clients of a running instance's facade — the
dead-letter quarantine, a tenant's flow-control quota, the flight
recorder's view and the fleet's placement (`GET /api/fleet`).

`fleet-worker` (`swx fleet-worker`): one fleet worker process attached
to a broker (`--bus`), hosting the scoring services for the tenants
that placement gives it; on the card, or the CPU with `--cpu` (without a
card and without `--cpu` it fails at start).

`lint` (ROADMAP A.6) and `bench` (A.1.5) are not ported: each raises
`NotImplementedError` naming its item.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import sys
import time

from sitewhere_tpu_torch.config import InstanceSettings
from sitewhere_tpu_torch.utils.roadmap import not_ported

# the scored pipeline's six (identifiers): `build_runtime`'s default
PIPELINE_SERVICES = ("device-management", "event-sources",
                     "inbound-processing", "event-management",
                     "device-state", "rule-processing")
# start order: identity/config first, then the pipeline, then aux (the
# JAX package's `_service_classes`)
ALL_SERVICES = ("InstanceManagementService", "DeviceManagementService",
                "AssetManagementService", "EventSourcesService",
                "InboundProcessingService", "EventManagementService",
                "DeviceStateService", "RuleProcessingService",
                "DeviceRegistrationService", "CommandDeliveryService",
                "OutboundConnectorsService", "BatchOperationsService",
                "ScheduleManagementService", "LabelGenerationService")


# cross-service dependencies that MUST be satisfied by a LOCAL peer —
# these call sites use the peer synchronously/deeply (e.g.
# event-management builds its SPI around the dm engine object), so a
# wire proxy cannot stand in. A split that violates this fails loudly
# at startup instead of misbehaving at runtime.
_COLOCATE = {
    "event-management": {"device-management"},
    "device-registration": {"device-management"},
    "command-delivery": {"device-management", "event-management"},
    "batch-operations": {"device-management", "event-management"},
    "schedule-management": {"device-management", "event-management",
                            "batch-operations"},
    "label-generation": {"device-management", "asset-management"},
    "rule-processing": {"event-management", "device-state"},
    # the REST facade calls nearly every engine synchronously — the
    # instance-management process is the full-facade process by design
    "instance-management": {"device-management", "event-management",
                            "asset-management", "device-state",
                            "rule-processing", "label-generation",
                            "batch-operations", "schedule-management"},
}
# services whose consumers guard for awaitable (wire-proxy) results —
# the only identifiers --remote currently supports
_WIRE_AWARE_REMOTES = {"device-management"}
# ...and which local services can actually use that remote peer
_REMOTE_CONSUMERS = {"device-management": {"inbound-processing"}}


def _validate_split(services, remotes, fleet_controller=False):
    if services is None:
        if remotes:
            # no --services = EVERY service hosted locally, so any
            # --remote collides with its local twin (api() resolution
            # would be ambiguous at runtime); fail at startup instead
            raise SystemExit(
                f"swx run: --remote {sorted(remotes)} conflicts with "
                f"hosting all services locally; use --services to pick "
                f"this process's subset")
        return
    for name in services:
        need = _COLOCATE.get(name, set())
        if fleet_controller and name == "instance-management":
            # a fleet-controller host serves /api/jwt, tenant CRUD, and
            # /api/fleet — the engine-touching routes 404/500 per
            # request for services the workers own (docs/FLEET.md); the
            # full-facade colocation rule would force this process to
            # host every pipeline service and dual-consume the shards
            need = set()
        missing = need - services
        if missing:
            raise SystemExit(
                f"swx run: service {name!r} must be colocated with "
                f"{sorted(missing)} (deep in-process integration); host "
                f"them in this process or drop {name!r} from --services")
    for identifier in remotes or ():
        if identifier in services:
            raise SystemExit(
                f"swx run: {identifier!r} is both local (--services) and "
                f"remote (--remote)")
        if identifier not in _WIRE_AWARE_REMOTES:
            raise SystemExit(
                f"swx run: --remote {identifier} is not supported yet — "
                f"only {sorted(_WIRE_AWARE_REMOTES)} have wire-aware "
                f"consumers")
        consumers = _REMOTE_CONSUMERS.get(identifier, set())
        if not consumers & services:
            raise SystemExit(
                f"swx run: --remote {identifier} is unused — none of "
                f"{sorted(services)} consume it over the wire")


def build_runtime(settings: InstanceSettings, services=PIPELINE_SERVICES,
                  bus=None, remotes=None, wire_secret=None,
                  fleet_controller=False):
    """A `ServiceRuntime` hosting `services`, identifiers among the
    fourteen of `ALL_SERVICES` (default: the scored pipeline's six;
    None: all fourteen, as `run` without `--services`); a subset is a
    process-split deployment. `bus` may be a RemoteEventBus; `remotes`
    maps identifier -> (host, port) of peers hosting other services."""
    from sitewhere_tpu_torch import services as service_classes
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime

    classes = {cls.identifier: cls for cls in
               (getattr(service_classes, name) for name in ALL_SERVICES)}
    if services is not None:
        services = set(services)
        unknown = services - set(classes)
        if unknown:
            raise SystemExit(f"swx run: unknown services {sorted(unknown)} "
                             f"(known: {sorted(classes)})")
    _validate_split(services, remotes, fleet_controller=fleet_controller)
    rt = ServiceRuntime(settings, bus=bus)
    for name, cls in classes.items():
        if services is None or name in services:
            rt.add_service(cls(rt))
    for identifier, (host, port) in (remotes or {}).items():
        rt.add_remote_service(identifier, host, port, secret=wire_secret)
    return rt


def _parse_addr(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    if not port.isdigit():
        raise SystemExit(f"swx: expected HOST:PORT, got {addr!r}")
    return host or "127.0.0.1", int(port)


def _stop_event() -> asyncio.Event:
    """Set on SIGINT or SIGTERM: the serving commands' shutdown."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover
            pass
    return stop


async def cmd_serve_bus(args) -> int:
    """Run the broker process: an EventBus served over the wire
    (kernel/wire.py). Peer `run --bus` processes attach to it."""
    from sitewhere_tpu_torch.kernel.bus import EventBus
    from sitewhere_tpu_torch.kernel.wire import BusServer

    bus = EventBus(default_partitions=args.partitions,
                   retention=args.retention)
    await bus.initialize()
    await bus.start()
    secret = args.secret or os.environ.get("SWX_WIRE_SECRET")
    server = BusServer(bus, host=args.host, port=args.port, secret=secret)
    await server.start()
    print(f"swx bus broker on {server.host}:{server.port}"
          + (" (auth required)" if secret else ""), flush=True)
    kafka_ep = None
    if args.kafka_port is not None:
        if secret and args.host not in ("127.0.0.1", "localhost", "::1"):
            # the Kafka endpoint has no SASL: serving the SAME bus
            # unauthenticated on a non-loopback interface would silently
            # bypass the wire secret
            raise SystemExit(
                "swx serve-bus: --kafka-port with --secret on a "
                f"non-loopback host ({args.host}) would expose the bus "
                "without auth; bind the kafka endpoint to loopback and "
                "front it with your own gateway/TLS, or drop --secret")
        from sitewhere_tpu_torch.kernel.kafka_endpoint import KafkaEndpoint

        kafka_ep = KafkaEndpoint(bus, host=args.host,
                                 port=args.kafka_port,
                                 auto_create_limit=args.kafka_auto_topics)
        await kafka_ep.start()
        print(f"swx kafka endpoint on {args.host}:{kafka_ep.port} "
              f"(UNAUTHENTICATED - trusted networks only)", flush=True)
    await _stop_event().wait()
    if kafka_ep is not None:
        await kafka_ep.stop()
    await server.stop()
    await bus.stop()
    return 0


async def cmd_run(args) -> int:
    import dataclasses

    from sitewhere_tpu_torch.config import TenantConfig, load_yaml_config

    if args.config:
        settings, tenants = load_yaml_config(args.config)
    else:
        settings = InstanceSettings.from_env()
        tenants = [TenantConfig(tenant_id="default", sections={
            "rule-processing": {"model": "zscore"},
            "event-sources": {"receivers": [
                {"kind": "queue", "decoder": "swb1", "name": "default"},
                {"kind": "tcp", "decoder": "swb1", "name": "gateway",
                 "port": args.gateway_port}]}})]
    if args.port is not None:
        settings = dataclasses.replace(settings, rest_port=args.port)
    if args.cpu:
        settings = dataclasses.replace(settings, device="cpu")

    # process-split deployment: subset of services + shared wire bus +
    # remote peers (reference: 14 cooperating processes over Kafka+gRPC)
    wire_secret = args.secret or os.environ.get("SWX_WIRE_SECRET")
    bus = None
    if args.bus:
        if args.kafka_port is not None:
            # arg-level conflict: fail BEFORE any service starts (the
            # late check would abort with live services + durable
            # writers never cleanly stopped)
            raise SystemExit(
                "swx run: --kafka-port needs the in-proc bus (this "
                "process attaches to a remote broker via --bus; put "
                "--kafka-port on the `swx serve-bus` process instead)")
        from sitewhere_tpu_torch.kernel.wire import RemoteEventBus

        bus = RemoteEventBus(*_parse_addr(args.bus), secret=wire_secret)
    services = set(args.services.split(",")) if args.services else None
    remotes = {}
    for spec in args.remote or ():
        identifier, eq, addr = spec.partition("=")
        if not eq:
            raise SystemExit(
                f"swx: --remote wants SVC=HOST:PORT, got {spec!r}")
        remotes[identifier] = _parse_addr(addr)

    if args.fleet_controller and settings.registry_replication is None:
        # controller host = the tenant-seeding host: its registry
        # mutations must reach the per-tenant registry-state topic so
        # workers adopt hermetically (docs/FLEET.md fencing protocol)
        settings = dataclasses.replace(settings, registry_replication=True)
    rt = build_runtime(settings, services=services, bus=bus,
                       remotes=remotes, wire_secret=wire_secret,
                       fleet_controller=args.fleet_controller)
    if args.fleet_controller:
        # this process is the fleet's control plane (docs/FLEET.md):
        # requires owning the broker bus (placement needs the central
        # committed/head view, and the controller peeks the control
        # topic for epoch recovery)
        if args.bus:
            raise SystemExit(
                "swx run: --fleet-controller must run in the broker "
                "process (in-proc bus); pair it with --kafka-port/"
                "peers attaching via `swx fleet-worker`, not --bus")
        from sitewhere_tpu_torch.fleet import FleetController

        rt.add_child(FleetController(rt))
    await rt.start()
    bus_server = None
    if args.serve_bus_port is not None:
        from sitewhere_tpu_torch.kernel.bus import EventBus
        from sitewhere_tpu_torch.kernel.wire import BusServer

        if not isinstance(rt.bus, EventBus):
            await rt.stop()
            raise SystemExit("swx run: --serve-bus-port needs the "
                             "in-proc bus (this process attaches to a "
                             "remote broker via --bus)")
        bus_server = BusServer(rt.bus, port=args.serve_bus_port,
                               secret=wire_secret)
        await bus_server.start()
        print(f"swx bus served to wire peers on "
              f"127.0.0.1:{bus_server.port}"
              + (" (auth required)" if wire_secret else ""), flush=True)
    api_server = None
    if args.api_port is not None:
        from sitewhere_tpu_torch.kernel.wire import ApiServer

        api_server = ApiServer(rt, host="127.0.0.1", port=args.api_port,
                               secret=wire_secret)
        await api_server.start()
        print(f"swx api server on 127.0.0.1:{api_server.port}", flush=True)
    if args.no_tenants:
        tenants = []
    for tenant in tenants:
        if "instance-management" in rt.services:
            im = rt.services["instance-management"]
            if im.tenant_store.get_tenant_by_token(
                    tenant.tenant_id) is not None:
                # durable restart (SWX_DATA_DIR): the tenant was
                # restored from the snapshot and is respinning — the
                # boot-time bootstrap must be idempotent, not fatal
                continue
            await im.create_tenant(tenant.tenant_id, tenant.name,
                                   dict(tenant.sections),
                                   tuple(tenant.authorized_user_ids))
        else:
            await rt.add_tenant(tenant)
    kafka_ep = None
    if args.kafka_port is not None:
        from sitewhere_tpu_torch.kernel.bus import EventBus
        from sitewhere_tpu_torch.kernel.kafka_endpoint import KafkaEndpoint

        assert isinstance(rt.bus, EventBus)  # enforced at arg parse
        kafka_ep = KafkaEndpoint(rt.bus, port=args.kafka_port,
                                 auto_create_limit=args.kafka_auto_topics,
                                 flow=rt.flow, naming=rt.naming)
        try:
            await kafka_ep.start()
        except OSError as exc:
            # bind failure AFTER services started: stop cleanly (durable
            # writers must flush) before failing loudly
            await rt.stop()
            raise SystemExit(
                f"swx run: kafka endpoint bind failed: {exc}") from exc
        print(f"swx kafka endpoint on 127.0.0.1:{kafka_ep.port} "
              f"(UNAUTHENTICATED - trusted networks only)", flush=True)
    im_svc = rt.services.get("instance-management")
    rest = im_svc.rest if im_svc is not None else None
    print(f"swx instance {settings.instance_id} up; "
          f"REST on {rest.host}:{rest.port}" if rest else
          f"swx instance {settings.instance_id} up (no REST in this "
          f"process)", flush=True)

    await _stop_event().wait()
    if kafka_ep is not None:
        await kafka_ep.stop()
    if bus_server is not None:
        await bus_server.stop()
    if api_server is not None:
        await api_server.stop()
    await rt.stop()
    return 0


async def _http_json(method: str, host: str, port: int, path: str,
                     headers: dict | None = None, body: dict | None = None,
                     timeout_s: float = 10.0) -> tuple[int, object]:
    """Tiny one-shot HTTP/1.1 JSON request (the REST-client commands'
    client; utils/http.py only ships POST-for-connectors)."""

    async def attempt():
        reader, writer = await asyncio.open_connection(host, port)
        try:
            payload = json.dumps(body).encode() if body is not None else b""
            head = [f"{method} {path} HTTP/1.1", f"Host: {host}",
                    "Connection: close", f"Content-Length: {len(payload)}"]
            if body is not None:
                head.append("Content-Type: application/json")
            for k, v in (headers or {}).items():
                head.append(f"{k}: {v}")
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + payload)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split()[1])
            resp_headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                resp_headers[k.strip().lower()] = v.strip()
            # the server keeps connections alive: read exactly the body,
            # never to EOF
            length = int(resp_headers.get("content-length", 0) or 0)
            data = await reader.readexactly(length) if length else b""
            return status, (json.loads(data) if data else None)
        finally:
            writer.close()

    return await asyncio.wait_for(attempt(), timeout_s)


async def cmd_dlq(args) -> int:
    """List/replay a tenant's dead-letter quarantine over the REST API
    (`swx dlq list` / `swx dlq replay`)."""
    import base64

    basic = base64.b64encode(
        f"{args.user}:{args.password}".encode()).decode()
    try:
        return await _dlq_request(args, basic)
    except (OSError, asyncio.TimeoutError, IndexError, ValueError) as exc:
        # unreachable/unresponsive server must not print a raw traceback
        print(f"swx dlq: cannot reach REST at {args.host}:{args.port}: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1


async def _dlq_request(args, basic: str) -> int:
    status, out = await _http_json(
        "POST", args.host, args.port, "/api/jwt",
        headers={"Authorization": f"Basic {basic}"})
    if status != 200:
        print(f"swx dlq: authentication failed ({status}): {out}",
              file=sys.stderr)
        return 1
    headers = {"Authorization": f"Bearer {out['token']}",
               "X-SiteWhere-Tenant": args.tenant}
    if args.action == "list":
        status, out = await _http_json(
            "GET", args.host, args.port, f"/api/dlq?limit={args.limit}",
            headers=headers)
    else:  # replay
        # always send the explicit limit: `--limit 0` must be a no-op,
        # not an accidental replay-everything
        status, out = await _http_json(
            "POST", args.host, args.port, "/api/dlq/replay",
            headers=headers, body={"limit": args.limit})
    if status != 200:
        print(f"swx dlq: {args.action} failed ({status}): {out}",
              file=sys.stderr)
        return 1
    print(json.dumps(out, indent=2))
    return 0


async def cmd_quota(args) -> int:
    """Inspect/set a tenant's flow-control quota over the REST API
    (`swx quota show` / `swx quota set --rate R [--burst B] [--weight W]`)."""
    import base64

    basic = base64.b64encode(
        f"{args.user}:{args.password}".encode()).decode()
    try:
        status, out = await _http_json(
            "POST", args.host, args.port, "/api/jwt",
            headers={"Authorization": f"Basic {basic}"})
        if status != 200:
            print(f"swx quota: authentication failed ({status}): {out}",
                  file=sys.stderr)
            return 1
        headers = {"Authorization": f"Bearer {out['token']}"}
        path = f"/api/tenants/{args.tenant}/quota"
        if args.action == "show":
            status, out = await _http_json("GET", args.host, args.port,
                                           path, headers=headers)
        else:  # set
            body = {k: v for k, v in (("rate", args.rate),
                                      ("burst", args.burst),
                                      ("weight", args.weight))
                    if v is not None}
            if not body:
                print("swx quota set: pass at least one of --rate/--burst/"
                      "--weight", file=sys.stderr)
                return 2
            status, out = await _http_json("PUT", args.host, args.port,
                                           path, headers=headers, body=body)
        if status != 200:
            print(f"swx quota: {args.action} failed ({status}): {out}",
                  file=sys.stderr)
            return 1
        print(json.dumps(out, indent=2))
        return 0
    except (OSError, asyncio.TimeoutError, IndexError, ValueError) as exc:
        print(f"swx quota: cannot reach REST at {args.host}:{args.port}: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1


def render_top(report: dict) -> str:
    """Render one flight-recorder report (`GET /api/instance/observe`)
    as the `swx top` screen. Pure function — tests and --json callers
    drive it directly."""
    lines: list[str] = []
    beat = report.get("beat")
    cp = report.get("critical_path") or {}
    # scope first: this view is ONE runtime. When this process hosts a
    # fleet of workers, everything below describes only the local
    # process (ingress + controller) — saying so stops the silent
    # "where did my workers' stages go" misread (`swx top --fleet` is
    # the merged view)
    fleet_workers = ((report.get("fleet") or {}).get("workers") or {})
    if fleet_workers:
        lines.append(
            f"scope: LOCAL runtime only — this host runs a fleet of "
            f"{len(fleet_workers)} worker(s) whose stages/lag are NOT "
            f"in the tables below; use `swx top --fleet` for the "
            f"fleet-wide view")
        lines.append("")
    if beat is None:
        lines.append("telemetry beat: DISABLED (observe_enabled=false)")
    else:
        lag = beat.get("loop_lag_ms", {})
        lines.append(
            f"beats {beat.get('beats', 0)}  "
            f"interval {beat.get('interval_ms', 0):.0f}ms  "
            f"loop-lag p50/p99/max {lag.get('p50', 0):.2f}/"
            f"{lag.get('p99', 0):.2f}/{lag.get('max', 0):.2f}ms  "
            f"stalls {beat.get('loop_stalls', 0)}  "
            f"consumer-lag max {beat.get('consumer_lag_max', 0)}")
    lines.append("")
    lines.append(f"critical path (sampled 1/{cp.get('sample', '?')}, "
                 f"{cp.get('span_count', 0)} spans) — queue-wait p99 "
                 f"{cp.get('queue_wait_p99_ms', 0):.2f}ms vs service p99 "
                 f"{cp.get('service_p99_ms', 0):.2f}ms")
    lines.append(f"  {'stage':<28} {'kind':<8} {'count':>6} "
                 f"{'p50ms':>8} {'p95ms':>8} {'p99ms':>8}")
    for stage, row in (cp.get("stages") or {}).items():
        lines.append(
            f"  {stage:<28} {row.get('kind', '?'):<8} "
            f"{row.get('count', 0):>6} {row.get('p50_ms', 0):>8.2f} "
            f"{row.get('p95_ms', 0):>8.2f} {row.get('p99_ms', 0):>8.2f}")
    if not cp.get("stages"):
        lines.append("  (no sampled spans yet)")
    last = (beat or {}).get("last") or {}
    if last:
        lags = last.get("consumer_lag") or {}
        top_lags = sorted(lags.items(), key=lambda kv: -kv[1])[:8]
        if top_lags:
            lines.append("")
            lines.append("consumer lag by group:")
            for group, lag_n in top_lags:
                lines.append(f"  {group:<44} {lag_n:>8}")
        scoring = last.get("scoring") or {}
        egress = last.get("egress_backlog") or {}
        flow = last.get("flow") or {}
        tenants = sorted(set(scoring) | set(egress) | set(flow))
        if tenants:
            lines.append("")
            lines.append(f"  {'tenant':<20} {'mode':<9} {'pressure':>8} "
                         f"{'pending':>8} {'inflight':>8} {'egress':>7}")
            for tid in tenants:
                sc = scoring.get(tid, {})
                fl = flow.get(tid, {})
                lines.append(
                    f"  {tid:<20} {fl.get('mode', '-'):<9} "
                    f"{fl.get('pressure', 0):>8.3f} "
                    f"{sc.get('pending', 0):>8} "
                    f"{sc.get('inflight', 0):>8} "
                    f"{egress.get(tid, 0):>7}")
    fleet = report.get("fleet")
    if fleet:
        lines.append("")
        lines.append(render_fleet(fleet))
    return "\n".join(lines)


def render_fleet_top(report: dict) -> str:
    """Render one fleet observe report (`GET /api/fleet/observe`,
    fleet/observer.py) as the `swx top --fleet` screen: the merged
    fleet critical path (queue-vs-service across process boundaries),
    per-worker beat matrix, per-tenant lag matrix with owners, mesh
    occupancy, broker stats. Pure function for tests."""
    lines: list[str] = []
    workers = report.get("workers") or {}
    tele = report.get("telemetry") or {}
    lines.append(
        f"fleet observe — {len(workers)} worker(s) reporting  "
        f"telemetry records {tele.get('records', 0)}  "
        f"observer lag {tele.get('observer_lag', 0)}")
    cp = report.get("critical_path") or {}
    lines.append("")
    lines.append(
        f"fleet critical path ({cp.get('span_count', 0)} spans over "
        f"{cp.get('workers_merged', 0)} process(es)) — queue-wait p99 "
        f"{cp.get('queue_wait_p99_ms', 0):.2f}ms vs service p99 "
        f"{cp.get('service_p99_ms', 0):.2f}ms")
    lines.append(f"  {'stage':<28} {'kind':<8} {'count':>6} "
                 f"{'p50ms':>8} {'p95ms':>8} {'p99ms':>8}")
    for stage, row in (cp.get("stages") or {}).items():
        lines.append(
            f"  {stage:<28} {row.get('kind', '?'):<8} "
            f"{row.get('count', 0):>6} {row.get('p50_ms', 0):>8.2f} "
            f"{row.get('p95_ms', 0):>8.2f} {row.get('p99_ms', 0):>8.2f}")
    if not cp.get("stages"):
        lines.append("  (no merged spans yet)")
    if workers:
        lines.append("")
        lines.append(f"  {'worker':<14} {'beats':>6} {'age':>6} "
                     f"{'lag-ms':>7} {'stalls':>6} {'c-lag':>6} "
                     f"{'egress':>7} {'pending':>8}")
        for wid, w in sorted(workers.items()):
            lines.append(
                f"  {wid:<14} {w.get('beats', 0):>6} "
                f"{w.get('beat_age_s', 0):>5.1f}s "
                f"{w.get('loop_lag_ms', 0):>7.2f} "
                f"{w.get('loop_stalls', 0):>6} "
                f"{w.get('consumer_lag_max', 0):>6} "
                f"{w.get('egress_backlog', 0):>7} "
                f"{w.get('scoring_pending', 0):>8}")
    matrix = report.get("lag_matrix") or {}
    if matrix:
        lines.append("")
        lines.append(f"  {'tenant':<20} {'owner':<14} {'lag':>8}")
        for tid, row in sorted(matrix.items(),
                               key=lambda kv: -kv[1].get("lag", 0)):
            lines.append(f"  {tid:<20} {row.get('worker') or '-':<14} "
                         f"{row.get('lag', 0):>8}")
    mesh = report.get("mesh") or {}
    if mesh:
        lines.append("")
        lines.append(f"  {'worker':<14} {'model':<10} {'devices':>7} "
                     f"{'rows':>9} {'occ':>6} {'win-ms':>7} "
                     f"{'tflops/dev':>11}")
        for wid, blocks in sorted(mesh.items()):
            for b in blocks:
                lines.append(
                    f"  {wid:<14} {b.get('model', '?'):<10} "
                    f"{b.get('devices', 0):>7} "
                    f"{b.get('tenant_rows', 0):>4}/"
                    f"{b.get('row_capacity', 0):<4} "
                    f"{b.get('row_occupancy', 0):>6.2f} "
                    f"{b.get('window_ms_live', 0):>7.2f} "
                    f"{b.get('model_tflops_per_device', 0):>11.5f}")
    broker = report.get("broker") or {}
    if broker:
        groups = broker.get("groups") or {}
        hot = sorted(((g, s.get("lag", 0)) for g, s in groups.items()),
                     key=lambda kv: -kv[1])[:6]
        lines.append("")
        lines.append(
            f"broker: {len(broker.get('topics') or {})} topics  "
            f"{len(groups)} groups  fence-rejections "
            f"{broker.get('fence_rejections', 0)}  members-evicted "
            f"{broker.get('members_evicted', 0)}")
        for group, lag_n in hot:
            if lag_n:
                lines.append(f"  {group:<44} lag {lag_n:>8}")
    history = report.get("history")
    if history:
        lines.append("")
        lines.append(
            f"history: {history.get('series', 0)} series  "
            f"{history.get('windows', 0)} windows  "
            f"{history.get('segments', 0)} segment(s)  "
            f"window {history.get('window_s', 0):.0f}s")
    forecast = report.get("forecast")
    if forecast:
        lines.append("")
        lines.append(render_forecast(forecast))
    return "\n".join(lines)


def render_forecast(snap: dict) -> str:
    """Render a predictive-planner snapshot (`GET /api/fleet/forecast`,
    fleet/forecast.py) — the forecast rows of `swx top --fleet`. Pure
    function for tests."""
    gate = snap.get("gate") or "ok"
    mode = "predictive" if gate == "ok" else f"reactive ({gate})"
    # error_ema is None until the first horizon check resolves (and
    # again right after a retrain re-arms the record)
    ema = snap.get("error_ema")
    lines = [
        f"forecast [{mode}] — horizon {snap.get('horizon_s') or 0:.0f}s  "
        f"model v{snap.get('model_version', 0)}  "
        f"err-ema {'n/a' if ema is None else format(ema, '.2f')}  "
        f"decisions {snap.get('decisions', 0)}  "
        f"demotions {snap.get('demotions', 0)}  "
        f"trainings {snap.get('trainings', 0)}"]
    forecasts = snap.get("forecasts") or {}
    if forecasts:
        lines.append(f"  {'tenant':<20} {'predicted':>10} {'age':>6} "
                     f"{'model':>6}")
        for tid, row in sorted(forecasts.items(),
                               key=lambda kv: -kv[1].get("load", 0)):
            lines.append(
                f"  {tid:<20} {row.get('load', 0):>10.0f} "
                f"{row.get('age_s', 0):>5.1f}s "
                f"v{row.get('model_version', 0):>5}")
    else:
        lines.append("  (no forecasts yet — tenant-0 slot warming)")
    return "\n".join(lines)


def render_fleet(status: dict) -> str:
    """Render a fleet status dict (`GET /api/fleet`) — the `swx fleet
    status` / `swx top` placement view. Pure function for tests."""
    lines = [
        f"fleet epoch {status.get('epoch', 0)}  "
        f"workers {len(status.get('workers') or {})}  "
        f"tenants {len(status.get('tenants') or [])}  "
        f"rebalances {status.get('rebalances', 0)}  "
        f"converged {status.get('converged', False)}"]
    workers = status.get("workers") or {}
    if workers:
        lines.append(f"  {'worker':<14} {'state':<9} {'owned':>5} "
                     f"{'pending':>7} {'hb-age':>7}  tenants")
        for wid, w in sorted(workers.items()):
            state = ("retiring" if w.get("retiring")
                     else "ready" if w.get("ready") else "syncing")
            owned = w.get("owned") or []
            lines.append(
                f"  {wid:<14} {state:<9} {len(owned):>5} "
                f"{len(w.get('pending') or []):>7} "
                f"{w.get('last_heartbeat_age_s', 0):>6.1f}s  "
                f"{','.join(owned[:6])}"
                + ("…" if len(owned) > 6 else ""))
    unplaced = status.get("unplaced") or []
    if unplaced:
        lines.append(f"  UNPLACED: {', '.join(unplaced)}")
    decisions = (status.get("autoscaler") or {}).get("decisions") or []
    if decisions:
        last = decisions[-1]
        lines.append(f"  autoscaler last: {last.get('action')} "
                     f"({last.get('reason')})"
                     + ("" if last.get("actuated") else " [advisory]"))
    return "\n".join(lines)


async def cmd_top(args) -> int:
    """Live operator view over `GET /api/instance/observe` — the
    flight recorder's critical path, loop-lag probe, consumer lag, and
    per-tenant flow/scoring state, refreshed every --interval."""
    try:
        headers = await _rest_login(args, "swx top")
        if headers is None:
            return 1
        fleet_mode = bool(getattr(args, "fleet", False))
        if fleet_mode:
            # fleet-wide view: served only by the controller host
            # (fleet/observer.py); workers keep the per-process view
            path = "/api/fleet/observe"
        else:
            path = "/api/instance/observe"
            if args.tenant:
                path += f"?tenant={args.tenant}"
        while True:
            status, report = await _http_json("GET", args.host, args.port,
                                              path, headers=headers)
            if status != 200:
                print(f"swx top: observe failed ({status}): {report}",
                      file=sys.stderr)
                return 1
            if fleet_mode:
                # forecast rows ride the same screen; a 404 just means
                # the predictive planner isn't running on this host
                fstatus, fsnap = await _http_json(
                    "GET", args.host, args.port, "/api/fleet/forecast",
                    headers=headers)
                if fstatus == 200:
                    report["forecast"] = fsnap
            if args.json:
                print(json.dumps(report))
            else:
                if not args.once:
                    # clear + home, like top(1); --once keeps scrollback
                    print("\x1b[2J\x1b[H", end="")
                print(f"swx top — {args.host}:{args.port}"
                      + (" [fleet]" if fleet_mode else "")
                      + (f" tenant={args.tenant}"
                         if args.tenant and not fleet_mode else ""))
                print(render_fleet_top(report) if fleet_mode
                      else render_top(report))
            if args.once:
                return 0
            await asyncio.sleep(max(args.interval, 0.2))
    except (OSError, asyncio.TimeoutError, IndexError, ValueError) as exc:
        print(f"swx top: cannot reach REST at {args.host}:{args.port}: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1
    except (KeyboardInterrupt, asyncio.CancelledError):
        # Ctrl-C reaches the coroutine as CancelledError under
        # asyncio.run — the operator's normal exit, not a traceback
        return 0


async def _rest_login(args, tool: str):
    """Basic-auth → /api/jwt → bearer headers (the REST-client
    subcommands' shared dance); None after printing the failure."""
    import base64

    basic = base64.b64encode(
        f"{args.user}:{args.password}".encode()).decode()
    status, out = await _http_json(
        "POST", args.host, args.port, "/api/jwt",
        headers={"Authorization": f"Basic {basic}"})
    if status != 200:
        print(f"{tool}: authentication failed ({status}): {out}",
              file=sys.stderr)
        return None
    return {"Authorization": f"Bearer {out['token']}"}


async def cmd_fleet(args) -> int:
    """`swx fleet status` — placement/liveness/autoscaler view over
    `GET /api/fleet` on the controller process's REST facade."""
    try:
        headers = await _rest_login(args, "swx fleet")
        if headers is None:
            return 1
        status, report = await _http_json("GET", args.host, args.port,
                                          "/api/fleet", headers=headers)
        if status != 200:
            print(f"swx fleet: status failed ({status}): {report}",
                  file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(report, indent=2))
        else:
            print(render_fleet(report))
        return 0
    except (OSError, asyncio.TimeoutError, IndexError, ValueError) as exc:
        print(f"swx fleet: cannot reach REST at {args.host}:{args.port}: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr)
        return 1


async def cmd_fleet_worker(args) -> int:
    """`swx fleet-worker` — run one fleet worker attached to a broker
    (`serve-bus`); tenant ownership arrives via placement records."""
    from sitewhere_tpu_torch.fleet.worker_main import amain

    cfg = {
        "worker_id": args.worker_id,
        "host": _parse_addr(args.bus)[0],
        "port": _parse_addr(args.bus)[1],
        "instance_id": args.instance,
        "secret": args.secret or os.environ.get("SWX_WIRE_SECRET"),
        "force_cpu": args.cpu,
        # worker-LOCAL durability only: registry state replicates over
        # the bus (docs/FLEET.md fencing protocol), so adoption needs no
        # shared filesystem — --data-dir just tightens the single-node
        # crash bound (registry WAL) and spills event history
        "settings": ({"data_dir": args.data_dir} if args.data_dir
                     else {}),
    }
    return await amain(cfg)


async def cmd_simulate(args) -> int:
    from sitewhere_tpu_torch.sim.clients import make_sender
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    sim = DeviceSimulator(SimConfig(num_devices=args.devices,
                                    anomaly_rate=args.anomaly_rate),
                          tenant_id=args.tenant)
    kw = {}
    if args.protocol == "mqtt":
        kw = {"topic": args.topic, "client_id": args.client_id,
              "username": args.username, "password": args.password}
    elif args.protocol == "coap":
        # --password doubles as the CoAP ingest shared secret
        # (Uri-Query token=<secret>, services/coap.py)
        kw = {"path": args.topic, "secret": args.password}
    elif args.protocol == "websocket":
        kw = {"client_id": args.client_id, "token": args.password}
    elif args.protocol == "amqp":
        kw = {"routing_key": args.topic,
              "username": args.username or "guest",
              "password": args.password or "guest"}
    elif args.protocol == "stomp":
        kw = {"destination": args.topic, "username": args.username,
              "password": args.password}
    sender = make_sender(args.protocol, args.host, args.port, **kw)
    await sender.connect()
    sent = 0
    t0 = time.monotonic()
    interval = 1.0 / args.rate if args.rate else 0.0
    try:
        while args.seconds <= 0 or time.monotonic() - t0 < args.seconds:
            payload, _ = sim.payload()
            await sender.send(payload)
            sent += args.devices
            if interval:
                await asyncio.sleep(interval)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await sender.close()
    rate = sent / max(time.monotonic() - t0, 1e-9)
    print(f"sent {sent} events over {args.protocol} ({rate:,.0f}/s)")
    return 0


async def cmd_demo(args) -> int:
    """Self-contained demo: instance + fleet + anomalies, report alerts."""
    from sitewhere_tpu_torch.domain.model import DeviceType
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    rt = build_runtime(InstanceSettings(
        instance_id="demo", rest_port=args.port or 0,
        device="cpu" if args.cpu else None), services=None)
    await rt.start()
    try:
        im = rt.services["instance-management"]
        await im.create_tenant("demo", "Demo", {
            "rule-processing": {"model": "zscore",
                                "model_config": {"window": 32},
                                "threshold": 5.0, "batch_window_ms": 2.0,
                                "buckets": [args.devices]}})
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
              f"on {session.device}, REST on port {im.rest.port} ...",
              flush=True)
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


async def cmd_replay(args) -> int:
    """Offline historical replay (history/): compact one tenant's
    durable log into the cold tier and stream `[--since, --until)`
    through a real SharedScoringPool at full speed. Runs against a
    STOPPED instance's data_dir."""
    from sitewhere_tpu_torch.history import (
        DivergenceGateError,
        EventHistoryStore,
        ReplayEngine,
        ScoreCollector,
    )
    from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.persistence.durable import SegmentLog
    from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool

    device = "cpu" if args.cpu else None
    # resolve the model first: with no card and no --cpu, fail before
    # touching the data_dir
    model = build_model(args.model, device=device, window=args.window)
    settings = InstanceSettings.from_env()
    tdir = os.path.join(args.data_dir, "tenants", args.tenant)
    events_dir = os.path.join(tdir, "events")
    history_dir = os.path.join(tdir, "history")
    if not os.path.isdir(events_dir) and not os.path.isdir(history_dir):
        print(f"replay: no durable log or cold tier under {tdir}",
              file=sys.stderr)
        return 2
    metrics = MetricsRegistry()
    source = SegmentLog(events_dir) if os.path.isdir(events_dir) else None
    store = EventHistoryStore(
        history_dir, source=source,
        window_s=args.history_window or settings.history_window_s,
        block_events=settings.history_block_events, metrics=metrics)
    try:
        if source is not None and not args.no_compact:
            # the owning instance is stopped, so fold the ACTIVE
            # segment too — "replay what just happened" must see it
            report = store.compact(through_seq=source._seq)
            print(f"compacted: {json.dumps(report)}", file=sys.stderr)
        print(f"cold tier: {json.dumps(store.stats())}", file=sys.stderr)
        pool = SharedScoringPool(model, metrics, PoolConfig(), device=device)
        engine = ReplayEngine(pool, metrics=metrics)
        try:
            if args.candidate:
                return await _replay_candidate(args, model, pool, engine,
                                               store, DivergenceGateError)
            report = await engine.replay(
                args.tenant, store, args.threshold, since=args.since,
                until=args.until, collect=ScoreCollector())
            print(json.dumps(report), flush=True)
            return 0
        finally:
            pool.close()
    finally:
        store.close()
        if source is not None:
            source.close()


async def _replay_candidate(args, model, pool, engine, store,
                            gate_error) -> int:
    """The shadow-scoring gate over a checkpointed candidate: 0 promoted,
    1 refused, 2 no checkpoint."""
    from sitewhere_tpu_torch.convert import params_from_numpy
    from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
    from sitewhere_tpu_torch.training.checkpoint import CheckpointStore

    ckpt = CheckpointStore(args.candidate)
    cand = None
    for owner in (args.tenant, "cli"):
        try:
            cand, _meta = ckpt.load(owner, args.model,
                                    version=args.candidate_version)
            break
        except FileNotFoundError:
            continue
    if cand is None:
        print(f"replay: no {args.model!r} checkpoint for {args.tenant!r} "
              f"(or 'cli') under {args.candidate}", file=sys.stderr)
        return 2

    async def _sink(_scored) -> None:
        return None

    slot = pool.register(args.tenant, TelemetryStore(), args.threshold, _sink)
    try:
        _version, report = await engine.guard_swap(
            slot, store, params_from_numpy(cand, model.device),
            since=args.since, until=args.until,
            max_divergence=args.max_divergence)
    except gate_error as exc:
        print(json.dumps(exc.report, default=str), flush=True)
        print(f"replay: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(report, default=str), flush=True)
    return 0


async def cmd_train(args) -> int:
    """Train a model over synthetic windows on one device; with
    --checkpoint, save the params as the `cli` tenant's next version."""
    import numpy as np

    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.training.checkpoint import CheckpointStore
    from sitewhere_tpu_torch.training.trainer import (
        Trainer,
        TrainerConfig,
        make_windows,
    )

    if args.distributed:
        raise not_ported("train --distributed (multi-host training)", "A.2")
    # the streaming model trains on the windowed objective (same weights)
    model = build_model(args.model if args.model != "lstm-stream" else "lstm",
                        device="cpu" if args.cpu else None,
                        window=args.window)
    rng = np.random.default_rng(args.seed)
    values = rng.normal(20.0, 2.0,
                        (args.devices, args.history)).astype(np.float32)
    windows, valid = make_windows(values, np.full(args.devices, args.history),
                                  window=args.window, max_windows=500_000)
    trainer = Trainer(model, TrainerConfig(batch_size=args.batch_size,
                                           steps=args.steps, seed=args.seed))
    params, report = trainer.train(windows, valid)
    print(json.dumps({"steps": report["steps"],
                      "final_loss": report["final_loss"],
                      "seconds": round(report["seconds"], 2)}), flush=True)
    if args.checkpoint:
        store = CheckpointStore(args.checkpoint)
        version = store.save("cli", args.model, params,
                             metadata={"window": args.window})
        print(f"checkpoint: {args.checkpoint}/cli/{args.model}/v{version}",
              flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sitewhere_tpu_torch.cli")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p_demo = sub.add_parser(
        "demo", help="one-process end-to-end demo: all fourteen "
        "services, REST, a tenant created through instance-management")
    p_demo.add_argument("--devices", type=int, default=1000)
    p_demo.add_argument("--seconds", type=float, default=5.0)
    p_demo.add_argument("--port", type=int,
                        help="REST port (default: a free one)")
    p_demo.add_argument("--cpu", action="store_true",
                        help="score on the CPU instead of the CUDA card")
    p_replay = sub.add_parser(
        "replay", help="compact a tenant's durable log into the cold tier "
        "and replay a time range through the scoring pool")
    p_replay.add_argument("--data-dir", required=True,
                          help="instance data_dir (tenants/<id>/events "
                               "and /history live under it)")
    p_replay.add_argument("--tenant", required=True)
    p_replay.add_argument("--since", type=float,
                          help="epoch seconds (window start, inclusive)")
    p_replay.add_argument("--until", type=float,
                          help="epoch seconds (window start, exclusive)")
    p_replay.add_argument("--model", default="zscore")
    p_replay.add_argument("--window", type=int, default=64)
    p_replay.add_argument("--threshold", type=float, default=6.0)
    p_replay.add_argument("--history-window", type=float,
                          help="cold-tier window width in seconds "
                               "(default: history_window_s)")
    p_replay.add_argument("--no-compact", action="store_true",
                          help="replay the cold tier as-is (skip the "
                               "compaction pass)")
    p_replay.add_argument("--candidate",
                          help="checkpoint root of a candidate model "
                               "(training/checkpoint.py layout) — run "
                               "the shadow-scoring gate instead of a "
                               "plain replay")
    p_replay.add_argument("--candidate-version", type=int)
    p_replay.add_argument("--max-divergence", type=float, default=0.5,
                          help="promotion bar on max |live − candidate| "
                               "score")
    p_replay.add_argument("--cpu", action="store_true",
                          help="score on the CPU instead of the CUDA card")
    p_train = sub.add_parser("train", help="train a model over synthetic "
                             "windows and checkpoint it")
    p_train.add_argument("--model", default="lstm")
    p_train.add_argument("--window", type=int, default=64)
    p_train.add_argument("--devices", type=int, default=1024)
    p_train.add_argument("--history", type=int, default=192)
    p_train.add_argument("--batch-size", type=int, default=1024)
    p_train.add_argument("--steps", type=int, default=200)
    p_train.add_argument("--seed", type=int, default=0)
    p_train.add_argument("--checkpoint", help="directory to save params to")
    p_train.add_argument("--distributed", action="store_true",
                         help="multi-host training (not ported)")
    p_train.add_argument("--cpu", action="store_true",
                         help="train on the CPU instead of the CUDA card")
    p_sim = sub.add_parser("simulate",
                           help="stream SWB1 at any ingest endpoint")
    p_sim.add_argument("--host", default="127.0.0.1")
    p_sim.add_argument("--port", type=int, default=47800)
    p_sim.add_argument("--protocol", default="tcp",
                       choices=["tcp", "mqtt", "coap", "websocket", "amqp", "stomp"],
                       help="which hosted endpoint to drive")
    p_sim.add_argument("--devices", type=int, default=1000)
    p_sim.add_argument("--tenant", default="default")
    p_sim.add_argument("--seconds", type=float, default=10.0)
    p_sim.add_argument("--rate", type=float, default=10.0,
                       help="batches per second (0 = unthrottled)")
    p_sim.add_argument("--anomaly-rate", type=float, default=0.0)
    p_sim.add_argument("--topic", default="telemetry",
                       help="MQTT topic / CoAP path / AMQP routing key")
    p_sim.add_argument("--client-id", default="swx-sim",
                       help="MQTT/WebSocket client id")
    p_sim.add_argument("--username", help="MQTT/AMQP username")
    p_sim.add_argument("--password",
                       help="MQTT/AMQP password; WebSocket bearer token; "
                            "CoAP ingest shared secret")

    p_run = sub.add_parser("run", help="run a full instance (or a subset "
                           "of services against a wire bus)")
    p_run.add_argument("--config", help="instance YAML")
    p_run.add_argument("--kafka-port", type=int, default=None,
                       help="also serve this instance's bus over the "
                            "Kafka wire protocol (0 = ephemeral)")
    p_run.add_argument("--kafka-auto-topics", type=int, default=256,
                       help="max topics the (unauthenticated) kafka "
                            "endpoint may auto-create for clients "
                            "(0 = none; existing topics always served)")
    p_run.add_argument("--port", type=int, help="REST port")
    p_run.add_argument("--gateway-port", type=int, default=47800)
    p_run.add_argument("--services",
                       help="comma-separated subset to host in THIS process")
    p_run.add_argument("--bus", metavar="HOST:PORT",
                       help="attach to a wire bus broker instead of an "
                            "in-proc bus (see `serve-bus`)")
    p_run.add_argument("--api-port", type=int,
                       help="serve this process's services to peers on "
                            "this port (0 = ephemeral)")
    p_run.add_argument("--remote", action="append", metavar="SVC=HOST:PORT",
                       help="peer process hosting SVC (repeatable)")
    p_run.add_argument("--no-tenants", action="store_true",
                       help="don't create tenants here (a peer process "
                            "broadcasts them over the shared bus)")
    p_run.add_argument("--secret",
                       help="shared secret for wire bus/API connections "
                            "(default: SWX_WIRE_SECRET env)")
    p_run.add_argument("--fleet-controller", action="store_true",
                       help="host the fleet control plane in this "
                            "process: placement/liveness/autoscaling "
                            "for `fleet-worker` peers (tenants created "
                            "here are registered for fleet placement; "
                            "serve the bus to workers with "
                            "--serve-bus-port)")
    p_run.add_argument("--serve-bus-port", type=int, default=None,
                       help="also serve this process's in-proc bus to "
                            "wire peers on this port (the fleet "
                            "workers' --bus target; 0 = ephemeral)")
    p_run.add_argument("--cpu", action="store_true",
                       help="score on the CPU instead of the CUDA card")

    p_bus = sub.add_parser("serve-bus", help="run the wire bus broker")
    p_bus.add_argument("--host", default="127.0.0.1")
    p_bus.add_argument("--port", type=int, default=47900)
    p_bus.add_argument("--partitions", type=int, default=4)
    p_bus.add_argument("--retention", type=int, default=4096)
    p_bus.add_argument("--kafka-port", type=int, default=None,
                       help="also serve the bus over the Kafka wire "
                            "protocol on this port (0 = ephemeral)")
    p_bus.add_argument("--kafka-auto-topics", type=int, default=256,
                       help="max topics the (unauthenticated) kafka "
                            "endpoint may auto-create for clients "
                            "(0 = none; existing topics always served)")
    p_bus.add_argument("--secret",
                       help="require this shared secret from every wire "
                            "peer (default: SWX_WIRE_SECRET env; unset = "
                            "open, loopback/test use)")

    p_dlq = sub.add_parser("dlq", help="list/replay a tenant's dead-letter "
                           "quarantine via the REST API")
    p_dlq.add_argument("action", choices=["list", "replay"])
    p_dlq.add_argument("--host", default="127.0.0.1")
    p_dlq.add_argument("--port", type=int, default=8080, help="REST port")
    p_dlq.add_argument("--tenant", default="default")
    p_dlq.add_argument("--limit", type=int, default=100,
                       help="max dead letters to list/replay")
    p_dlq.add_argument("--user", default="admin")
    p_dlq.add_argument("--password", default="password")

    p_quota = sub.add_parser("quota", help="inspect/set a tenant's "
                             "flow-control quota via the REST API")
    p_quota.add_argument("action", choices=["show", "set"])
    p_quota.add_argument("--host", default="127.0.0.1")
    p_quota.add_argument("--port", type=int, default=8080, help="REST port")
    p_quota.add_argument("--tenant", default="default")
    p_quota.add_argument("--rate", type=float,
                         help="events/sec (0 = unlimited)")
    p_quota.add_argument("--burst", type=float, help="burst events")
    p_quota.add_argument("--weight", type=float,
                         help="weighted-fair inbound share")
    p_quota.add_argument("--user", default="admin")
    p_quota.add_argument("--password", default="password")

    p_top = sub.add_parser("top", help="live flight-recorder view "
                           "(critical path, loop lag, consumer lag, flow "
                           "modes) via the REST API")
    p_top.add_argument("--host", default="127.0.0.1")
    p_top.add_argument("--port", type=int, default=8080, help="REST port")
    p_top.add_argument("--interval", type=float, default=2.0,
                       help="refresh period in seconds")
    p_top.add_argument("--once", action="store_true",
                       help="print one report and exit (scripts/tests)")
    p_top.add_argument("--json", action="store_true",
                       help="print the raw observe JSON instead of the "
                            "rendered table")
    p_top.add_argument("--tenant", default=None,
                       help="filter the critical path to one tenant")
    p_top.add_argument("--fleet", action="store_true",
                       help="fleet-wide view via /api/fleet/observe on "
                            "the controller host")
    p_top.add_argument("--user", default="admin")
    p_top.add_argument("--password", default="password")

    p_fleet = sub.add_parser("fleet", help="fleet control-plane status "
                             "(placement, worker liveness, autoscaler) "
                             "via the REST API")
    p_fleet.add_argument("action", choices=["status"])
    p_fleet.add_argument("--host", default="127.0.0.1")
    p_fleet.add_argument("--port", type=int, default=8080, help="REST port")
    p_fleet.add_argument("--json", action="store_true",
                         help="print the raw status JSON")
    p_fleet.add_argument("--user", default="admin")
    p_fleet.add_argument("--password", default="password")

    p_fworker = sub.add_parser("fleet-worker", help="run one fleet worker "
                               "against a wire bus broker; tenant "
                               "ownership arrives via fleet placement "
                               "records")
    p_fworker.add_argument("--bus", required=True, metavar="HOST:PORT",
                           help="the broker (`serve-bus`, or `run "
                                "--fleet-controller --serve-bus-port`)")
    p_fworker.add_argument("--worker-id", required=True,
                           help="stable worker identity (placement key)")
    p_fworker.add_argument("--instance", default="swx1",
                           help="instance id (must match the broker's "
                                "topic naming)")
    p_fworker.add_argument("--secret",
                           help="wire shared secret (default: "
                                "SWX_WIRE_SECRET env)")
    p_fworker.add_argument("--data-dir",
                           help="OPTIONAL worker-local durability root "
                                "(registry WAL + snapshots, event "
                                "spill). NOT shared: tenant registry "
                                "state replicates over the bus, so a "
                                "worker adopts from bus replay alone")
    p_fworker.add_argument("--cpu", action="store_true",
                           help="score on the CPU instead of the CUDA card")

    p_lint = sub.add_parser("lint", help="run swxlint over the package "
                            "(not ported)")
    p_lint.add_argument("--root")
    p_lint.add_argument("--format", choices=["text", "json"],
                        default="text")
    p_lint.add_argument("--baseline")
    p_lint.add_argument("--write-baseline", action="store_true")
    p_lint.add_argument("--dump-registry", action="store_true")

    sub.add_parser("bench", help="run the benchmark (not ported)")

    # `bench` takes the benchmark's flags, as the JAX package forwards
    # them; every other command only its own
    args, extra = parser.parse_known_args(argv)
    if extra and args.cmd != "bench":
        parser.error(f"unrecognized arguments: {' '.join(extra)}")
    if args.cmd == "lint":
        raise not_ported("lint (swxlint over the port)", "A.6")
    if args.cmd == "bench":
        raise not_ported("the port's bench entry", "A.1.5")
    return asyncio.run({"demo": cmd_demo, "replay": cmd_replay,
                        "train": cmd_train, "simulate": cmd_simulate,
                        "run": cmd_run, "serve-bus": cmd_serve_bus,
                        "dlq": cmd_dlq, "quota": cmd_quota,
                        "top": cmd_top, "fleet": cmd_fleet,
                        "fleet-worker": cmd_fleet_worker}[args.cmd](args))


if __name__ == "__main__":
    sys.exit(main())
