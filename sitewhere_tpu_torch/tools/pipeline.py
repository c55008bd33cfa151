"""The bench's scored pipeline at full width, as `chip_smoke.py` drives it.

`build` makes what `bench.py` deploys by default: a `ServiceRuntime`
with the six pipeline services (device-management, event-sources,
inbound-processing, event-management, device-state, rule-processing),
one tenant of 32,768 devices with the bench's `rule-processing` section
(`lstm-stream`, window 64, threshold 6.0, batch window 2 ms, one
fleet-sized bucket, ring capacity = the fleet, 8 flushes in flight,
megabatch on, full readback) and event-management history 256. Traffic
enters through the tenant's in-proc event-sources receiver, crosses the
fused ingress fast lane into the scoring pool (or, megabatch off, a
dedicated session) and leaves through the fused egress stage to the
tenant's scored-events topic. W+4 ticks of warm history go straight into
the store, then the ring reloads from it (as the bench does). Every
trace is sampled (`trace_sample=1`) so the stages' host time reads off
the tracer. Runs on the CUDA card. `FLEET` is read when `build` runs,
so setting it sizes the whole pipeline. With `data_dir` (the bench's
`--durable DIR`) the runtime spills every persisted batch to a durable
log and snapshots its registry there, and `build` returns once the new
fleet's registry snapshot is on disk; a `build` on a directory that
already holds them restores the store and the registry instead of
registering the fleet again. `deploy` takes every lever of the bench's
default run (`Deployment`: tenants, pooled, megabatch, the batch window,
flushes in flight, history, readback, egress fusion and lanes, the fast
lane, the flight recorder, durability, chaos) and returns one `Pipeline`
a tenant on one runtime; `build` is its single-tenant default.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from sitewhere_tpu_torch.analysis.registry import FAULT_SITES
from sitewhere_tpu_torch.cli import build_runtime
from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
from sitewhere_tpu_torch.domain.model import DeviceType
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

SEED = 0
FLEET = 32768
WINDOW = 64
HISTORY = 256
THRESHOLD = 6.0
TICK_S = 60.0
TENANT = "bench"
WARMUP_TIMEOUT_S = 300.0


@dataclass
class Pipeline:
    rt: Any
    engine: Any        # the tenant's RuleProcessingEngine
    sink: Any          # its pool slot or dedicated session
    em: Any            # its event-management engine
    receiver: Any      # the tenant's "default" queue receiver
    sim: DeviceSimulator
    sim_cfg: SimConfig
    t: float           # time of the first tick after the warm history

    @property
    def tenant(self) -> str:
        return self.engine.tenant_id

    def scored_consumer(self):
        return self.rt.bus.subscribe(
            self.rt.naming.tenant_topic(self.tenant,
                                        TopicNaming.SCORED_EVENTS),
            group="smoke-scored")

    def inbound_lag(self) -> int:
        """Decoded-topic records the `{tenant}.inbound-processing` group
        has not committed yet."""
        decoded = self.rt.naming.tenant_topic(
            self.tenant, TopicNaming.EVENT_SOURCE_DECODED)
        lags = self.rt.bus.group_lags()[f"{self.tenant}.inbound-processing"]
        return lags.get(decoded, 0)

    async def stop(self) -> None:
        await self.rt.stop()


@dataclass
class Deployment:
    """The levers of the bench's default deployment (`bench.py:2319-2409`),
    as its flags name them. `devices` is the whole fleet, split over the
    tenants (None: `FLEET`, read when `deploy` runs); `pooled` > 1 puts
    that many tenants on one shared pool (`shared: true`); `chaos` arms
    fault sites before the services start, `{site: (rate, max_faults)}`
    with `chaos_seed`."""
    model: str = "lstm-stream"
    devices: Optional[int] = None
    tenants: int = 1
    pooled: int = 1
    megabatch: bool = True
    window: int = WINDOW
    window_ms: float = 2.0
    max_inflight: int = 8
    history: int = HISTORY
    readback: str = "full"
    egress_fused: bool = True
    egress_lanes: int = 1
    egress_autotune: bool = False
    fastlane: bool = True
    observe: bool = True
    data_dir: Optional[str] = None
    device: Optional[str] = None
    trace_sample: int = 1
    ready_timeout_s: float = WARMUP_TIMEOUT_S
    # the traffic simulators' anomalies (the bench's: 0.001 at 12 sigma)
    anomaly_rate: float = 0.0
    chaos: dict = field(default_factory=dict)
    chaos_seed: int = 0
    # the serving mesh `{data, model}` of the shared pool (None: none),
    # and the logical CPU devices a CPU run may span
    mesh: Optional[dict] = None
    cpu_mesh_devices: int = 1

    @property
    def tenant_ids(self) -> list[str]:
        n = max(self.pooled, self.tenants, 1)
        return [f"{TENANT}{i}" for i in range(n)] if n > 1 else [TENANT]


def tenant_sections(dep: Deployment, per_tenant: int) -> dict:
    """A tenant's sections in the bench's default deployment."""
    return {
        **({} if dep.fastlane else {"fastlane": {"enabled": False}}),
        "egress": {"fused": dep.egress_fused,
                   "lanes": max(dep.egress_lanes, 1),
                   "autotune": dep.egress_autotune},
        "event-management": {"history": dep.history},
        "rule-processing": {
            "model": dep.model,
            "model_config": {"window": dep.window},
            "threshold": THRESHOLD,
            "batch_window_ms": dep.window_ms,
            # one fleet-sized bucket: one flush is one dispatch
            "buckets": [per_tenant],
            "capacity": per_tenant,
            "max_inflight": dep.max_inflight,
            "readback": dep.readback,
            "shared": dep.pooled > 1,
            "megabatch": {"enabled": dep.megabatch},
            **({"mesh": dict(dep.mesh)} if dep.mesh else {}),
        },
    }


async def deploy(dep: Deployment) -> list[Pipeline]:
    """The bench's default deployment, warmed and ready to take ticks: one
    `Pipeline` a tenant, all on one runtime (tenant i's simulator from
    seed SEED + i)."""
    from sitewhere_tpu_torch.kernel.faults import FaultInjector

    tenant_ids = dep.tenant_ids
    devices = FLEET if dep.devices is None else dep.devices
    per_tenant = max(devices // len(tenant_ids), 1)
    rt = build_runtime(InstanceSettings(
        instance_id="bench", trace_sample=dep.trace_sample,
        data_dir=dep.data_dir, device=dep.device,
        engine_ready_timeout_s=dep.ready_timeout_s,
        observe_enabled=dep.observe,
        cpu_mesh_devices=dep.cpu_mesh_devices,
        # the bench's shed policy: reject at ingress only
        flow_degrade_at=10.0, flow_defer_at=10.0))
    if dep.chaos:
        injector = rt.install_faults(FaultInjector(seed=dep.chaos_seed))
        for site, (rate, max_faults) in dep.chaos.items():
            if site not in FAULT_SITES:
                raise ValueError(f"chaos site {site!r} is not a registered "
                                 f"fault site (analysis/registry.py)")
            # the registry vouches for the site on the line above
            injector.arm(site, rate=rate, max_faults=max_faults)  # swxlint: disable=FLT01
    await rt.start()
    try:
        sections = tenant_sections(dep, per_tenant)
        for tid in tenant_ids:
            await rt.add_tenant(TenantConfig(tenant_id=tid, sections=sections),
                                timeout=dep.ready_timeout_s)
        pipes, waits = [], []
        for i, tid in enumerate(tenant_ids):
            dm = rt.api("device-management").management(tid)
            em = rt.api("event-management").management(tid)
            spikes = ({"anomaly_rate": dep.anomaly_rate,
                       "anomaly_magnitude": 12.0} if dep.anomaly_rate else {})
            sim_cfg = SimConfig(num_devices=per_tenant, seed=SEED + i,
                                **spikes)
            sim = DeviceSimulator(sim_cfg, tenant_id=tid)
            if dm.restored_from is None:
                dm.bootstrap_fleet(DeviceType(token="thermo",
                                              name="Thermometer"), per_tenant)
                for k in range(dep.window + 4):
                    em.telemetry.append_measurements(sim.tick(t=TICK_S * k)[0])
            engine = rt.api("rule-processing").engine(tid)
            sink = engine.session or engine.pool_slot
            # a registry just registered on a data_dir: its first snapshot
            # (the whole fleet, seconds of codec encode beside the loop)
            # is set-up, not part of the traffic that follows
            snapshot = dep.data_dir is not None and dm.restored_from is None
            waits.append((sink, dm, snapshot))
            receiver = rt.api("event-sources").engine(tid).receiver("default")
            pipes.append(Pipeline(rt, engine, sink, em, receiver, sim,
                                  sim_cfg, TICK_S * (dep.window + 4)))
        deadline = time.monotonic() + dep.ready_timeout_s
        while not all(sink.ready and (dm.snapshot_current or not snap)
                      for sink, dm, snap in waits):
            if time.monotonic() > deadline:
                raise TimeoutError(f"scoring warmup or the registry snapshot "
                                   f"not done in {dep.ready_timeout_s} s")
            await asyncio.sleep(0.01)
        # the warm history entered the store directly: reseed the rings
        for pipe in pipes:
            pipe.sink.reload_history()
        return pipes
    except BaseException:
        await rt.stop()
        raise


async def build(model: str = "lstm-stream", megabatch: bool = True,
                data_dir: str | None = None) -> Pipeline:
    """The bench's default deployment (`model`, `megabatch`, `data_dir`
    as its `--model` / `--megabatch` / `--durable` levers), warmed and
    ready to take ticks."""
    return (await deploy(Deployment(model=model, megabatch=megabatch,
                                    data_dir=data_dir)))[0]


async def collect_scored(consumer, want: int, timeout: float = 120.0):
    """Poll `consumer` until `want` scored events arrived; returns (the
    scored batches in arrival order, monotonic time of the last one)."""
    got, n, t_last = [], 0, None
    deadline = time.monotonic() + timeout
    while n < want:
        left = deadline - time.monotonic()
        if left <= 0:
            raise TimeoutError(f"{n} of {want} scored events in {timeout} s")
        for rec in await consumer.poll(max_records=512,
                                       timeout=min(left, 0.5)):
            got.append(rec.value)
            n += len(rec.value)
            t_last = time.monotonic()
    return got, t_last


def scored_table(batches) -> dict:
    """{(device_index, ts): (score, is_anomaly, times seen)} over scored
    batches — a key seen twice marks a double delivery."""
    table: dict = {}
    for b in batches:
        for d, ts, s, a in zip(b.device_index.tolist(), b.ts.tolist(),
                               b.score.tolist(), b.is_anomaly.tolist()):
            prev = table.get((d, ts))
            table[(d, ts)] = (s, a, 1 + (prev[2] if prev else 0))
    return table


def stage_ms(rt) -> dict:
    """Host time per span of the pipeline's stages (mean and p50 ms over
    every sampled trace): decode, fast lane (`inbound.enrich`), persist,
    dispatch wait, score (dispatch → scores on host), publish."""
    return {stage: {"mean_ms": row["mean_ms"], "p50_ms": row["p50_ms"],
                    "spans": row["count"]}
            for stage, row in rt.tracer.stage_summary().items()}


def latency_ms(rt) -> dict:
    """`scoring.e2e_latency_s` p50/p99 from the runtime's registry, ms."""
    h = rt.metrics.histogram("scoring.e2e_latency_s")
    return {"e2e_p50_ms": 1e3 * h.quantile(0.5),
            "e2e_p99_ms": 1e3 * h.quantile(0.99), "e2e_count": h.count}


def ticks(pipe: Pipeline, n: int, anomaly_at: int) -> list:
    """`n` fleet ticks after the warm history, tick `anomaly_at` with 5%
    of devices spiking by 12 sigma: [(batch, truth)]."""
    out = []
    for k in range(n):
        t = pipe.t + TICK_S * k
        if k == anomaly_at:
            pipe.sim.cfg = SimConfig(num_devices=pipe.sim_cfg.num_devices,
                                     seed=pipe.sim_cfg.seed,
                                     anomaly_rate=0.05,
                                     anomaly_magnitude=12.0)
            out.append(pipe.sim.tick(t=t))
            pipe.sim.cfg = pipe.sim_cfg
        else:
            out.append(pipe.sim.tick(t=t))
    return out
