"""`python -m sitewhere_tpu_torch.cli` — the port's entry point.

    python -m sitewhere_tpu_torch.cli demo [--devices N] [--seconds S]
        [--port P] [--cpu]
    python -m sitewhere_tpu_torch.cli replay --data-dir D --tenant T [--cpu]
        [--candidate DIR [--candidate-version N] [--max-divergence X]]
    python -m sitewhere_tpu_torch.cli train [--model lstm] [--steps N]
        [--checkpoint DIR] [--cpu]
    python -m sitewhere_tpu_torch.cli simulate [--protocol P] [--port N]
        [--devices N] [--seconds S] [--rate R]

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

The other commands (`run`, `dlq`, `quota`, `top`, `fleet`) are ROADMAP
A.1.5.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

from sitewhere_tpu_torch.config import InstanceSettings
from sitewhere_tpu_torch.utils.roadmap import not_ported

PIPELINE_SERVICES = ("DeviceManagementService", "EventSourcesService",
                     "InboundProcessingService", "EventManagementService",
                     "DeviceStateService", "RuleProcessingService")
# start order: identity/config first, then the pipeline, then aux (the
# JAX package's `_service_classes`)
ALL_SERVICES = ("InstanceManagementService", "DeviceManagementService",
                "AssetManagementService", "EventSourcesService",
                "InboundProcessingService", "EventManagementService",
                "DeviceStateService", "RuleProcessingService",
                "DeviceRegistrationService", "CommandDeliveryService",
                "OutboundConnectorsService", "BatchOperationsService",
                "ScheduleManagementService", "LabelGenerationService")


def build_runtime(settings: InstanceSettings, names=PIPELINE_SERVICES):
    """A `ServiceRuntime` hosting `names` (default: the scored
    pipeline's six services; `ALL_SERVICES` for the whole platform)."""
    from sitewhere_tpu_torch import services
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime

    rt = ServiceRuntime(settings)
    for name in names:
        rt.add_service(getattr(services, name)(rt))
    return rt


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
        device="cpu" if args.cpu else None), ALL_SERVICES)
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
    args = parser.parse_args(argv)
    return asyncio.run({"demo": cmd_demo, "replay": cmd_replay,
                        "train": cmd_train,
                        "simulate": cmd_simulate}[args.cmd](args))


if __name__ == "__main__":
    sys.exit(main())
