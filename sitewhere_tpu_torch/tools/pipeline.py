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
registering the fleet again.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any

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


async def build(model: str = "lstm-stream", megabatch: bool = True,
                data_dir: str | None = None) -> Pipeline:
    """The bench's default deployment (`model`, `megabatch`, `data_dir`
    as its `--model` / `--megabatch` / `--durable` levers), warmed and
    ready to take ticks."""
    devices = FLEET
    rt = build_runtime(InstanceSettings(
        instance_id="bench", trace_sample=1, data_dir=data_dir,
        # the bench's shed policy: reject at ingress only
        flow_degrade_at=10.0, flow_defer_at=10.0))
    await rt.start()
    await rt.add_tenant(TenantConfig(tenant_id=TENANT, sections={
        "egress": {"fused": True, "lanes": 1, "autotune": False},
        "event-management": {"history": HISTORY},
        "rule-processing": {
            "model": model,
            "model_config": {"window": WINDOW},
            "threshold": THRESHOLD,
            "batch_window_ms": 2.0,
            "buckets": [devices],
            "capacity": devices,
            "max_inflight": 8,
            "readback": "full",
            "shared": False,
            "megabatch": {"enabled": megabatch},
        },
    }), timeout=WARMUP_TIMEOUT_S)
    dm = rt.api("device-management").management(TENANT)
    em = rt.api("event-management").management(TENANT)
    sim_cfg = SimConfig(num_devices=devices, seed=SEED)
    sim = DeviceSimulator(sim_cfg, tenant_id=TENANT)
    if dm.restored_from is None:
        dm.bootstrap_fleet(DeviceType(token="thermo", name="Thermometer"),
                           devices)
        for k in range(WINDOW + 4):
            em.telemetry.append_measurements(sim.tick(t=TICK_S * k)[0])
    engine = rt.api("rule-processing").engine(TENANT)
    sink = engine.session or engine.pool_slot
    # a registry just registered on a data_dir: its first snapshot (the
    # whole fleet, seconds of codec encode beside the loop) is set-up,
    # not part of the traffic that follows
    snapshot = data_dir is not None and dm.restored_from is None
    deadline = time.monotonic() + WARMUP_TIMEOUT_S
    while not sink.ready or (snapshot and not dm.snapshot_current):
        if time.monotonic() > deadline:
            raise TimeoutError(f"scoring warmup or the registry snapshot "
                               f"not done in {WARMUP_TIMEOUT_S} s")
        await asyncio.sleep(0.01)
    # the warm history entered the store directly: reseed the ring
    sink.reload_history()
    receiver = rt.api("event-sources").engine(TENANT).receiver("default")
    return Pipeline(rt, engine, sink, em, receiver, sim, sim_cfg,
                    TICK_S * (WINDOW + 4))


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
