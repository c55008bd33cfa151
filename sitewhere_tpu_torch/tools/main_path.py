"""The port's serving paths at full width, as `chip_smoke.py` drives them.

`build` makes a dedicated `ScoringSession` (the windowed `lstm` model by
default, or any registry model) over a 32,768-device simulated fleet,
buckets 256…16384; `build_pool` makes a `SharedScoringPool` over
`tenants` tenants of `devices` devices each, each tenant with its own
weights (one seed per tenant). Each model runs at the width the repo
configures for it (`MODEL_CFG`: the LSTMs at W=64, h=64, 1 layer; `tft`
at `TftConfig`'s defaults, the bench's `--model tft`; `longwin` as the
bench runs it, `--window 64`; `seasonal` at its defaults), bf16, random
weights from seeds; both fill every store with W+4 ticks and warm up
before returning. `chip_smoke.py` and `tools/flush_profile.py` build
them here, so both measure the same paths. Needs one CUDA card.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from sitewhere_tpu_torch.domain.batch import (
    BatchContext,
    MeasurementBatch,
    ScoredBatch,
)
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

SEED = 0
BUCKETS = (256, 1024, 4096, 16384)
WINDOW, HIDDEN = 64, 64
FLEET = 32768
# each registry model at the width the repo configures for it
MODEL_CFG = {
    "lstm": dict(window=WINDOW, hidden=HIDDEN),
    "lstm-stream": dict(window=WINDOW, hidden=HIDDEN),
    "tft": {},                      # TftConfig: W=64, H=8, d=32, 4 heads
    "longwin": dict(window=WINDOW),  # bench.py --window 64: d=32, 2 layers
    "seasonal": {},                 # SeasonalTrendConfig: W=32, H=6
}
TICK_S = 60.0
THRESHOLD = 4.0


def _wire(batch: MeasurementBatch, tenant: str) -> MeasurementBatch:
    """One gateway batch through SWB1 encode → decode, as the service's
    ingress hands it on."""
    return MeasurementBatch.decode(
        batch.encode(), BatchContext(tenant_id=tenant, source="gateway"))


def filled_store(sim: DeviceSimulator, devices: int,
                  window: int = WINDOW) -> TelemetryStore:
    """A host store for `devices` devices holding `window` + 4 of `sim`'s
    ticks."""
    store = TelemetryStore(history=max(128, 2 * window),
                           initial_devices=devices)
    for k in range(window + 4):
        store.append_measurements(sim.tick(t=TICK_S * k)[0])
    return store


@dataclass
class MainPath:
    model: Any
    store: TelemetryStore
    sim: DeviceSimulator
    sim_cfg: SimConfig
    metrics: MetricsRegistry
    session: ScoringSession
    tenant: str
    t: float  # time of the first tick after the store fill

    def ingest(self, batch: MeasurementBatch) -> None:
        """One gateway batch through SWB1 encode → decode → host store →
        admit."""
        wire = _wire(batch, self.tenant)
        self.store.append_measurements(wire)
        self.session.admit(wire)


def build(tenant: str, model: str = "lstm", **cfg: Any) -> MainPath:
    """A warmed dedicated session on `model` (at `MODEL_CFG[model]`);
    `cfg` overrides `ScoringConfig` fields (e.g. `readback="anomalies"`)."""
    scorer = build_model(model, **MODEL_CFG[model])
    window = scorer.cfg.window
    sim_cfg = SimConfig(num_devices=FLEET, seed=SEED)
    sim = DeviceSimulator(sim_cfg, tenant_id=tenant)
    store = filled_store(sim, FLEET, window)
    metrics = MetricsRegistry()
    session = ScoringSession(scorer, store, metrics,
                             ScoringConfig(buckets=BUCKETS, capacity=FLEET,
                                           threshold=THRESHOLD, seed=SEED,
                                           **cfg))
    session.warmup()
    return MainPath(scorer, store, sim, sim_cfg, metrics, session, tenant,
                    TICK_S * (window + 4))


@dataclass
class PoolTenant:
    store: TelemetryStore
    sim: DeviceSimulator
    sim_cfg: SimConfig
    params: dict
    delivered: list = field(default_factory=list)


@dataclass
class PoolPath:
    model: Any
    metrics: MetricsRegistry
    pool: SharedScoringPool
    tenants: dict[str, PoolTenant]
    t: float  # time of the first tick after the store fill
    arrived: asyncio.Event  # set by every delivery

    def ingest(self, tenant: str, batch: MeasurementBatch) -> None:
        """One gateway batch through SWB1 encode → decode → the tenant's
        host store → admit."""
        wire = _wire(batch, tenant)
        self.tenants[tenant].store.append_measurements(wire)
        self.pool.admit(tenant, wire)

    async def flush(self, timeout: float = 60.0) -> dict[str, ScoredBatch]:
        """Close the megabatch (now when it is due — every tenant holding
        a full bucket — else at its deadline, by the pool's flusher) and
        await the delivery of every pending event; returns each tenant's
        scored events of this flush, in delivery order."""
        want = {tid: e.pending_n for tid, e in self.pool.tenants.items()
                if e.pending_n}
        seen = {tid: len(self.tenants[tid].delivered) for tid in want}

        def missing() -> bool:
            return any(sum(max(b.total_scored, len(b)) for b in
                           self.tenants[tid].delivered[seen[tid]:]) < n
                       for tid, n in want.items())

        self.pool.flush_nowait()
        deadline = time.monotonic() + timeout
        while missing():
            self.arrived.clear()  # no await since the check: no race
            try:
                await asyncio.wait_for(self.arrived.wait(),
                                       max(deadline - time.monotonic(), 0.0))
            except asyncio.TimeoutError:
                raise TimeoutError(
                    f"pool flush not delivered in {timeout} s") from None
        out = {}
        for tid in want:
            new = self.tenants[tid].delivered[seen[tid]:]
            out[tid] = ScoredBatch(
                new[0].ctx,
                np.concatenate([b.device_index for b in new]),
                np.concatenate([b.score for b in new]),
                np.concatenate([b.is_anomaly for b in new]),
                np.concatenate([b.ts for b in new]),
                model_version=new[0].model_version)
        return out


async def build_pool(prefix: str, model: str, tenants: int, devices: int,
                     buckets: tuple[int, ...], timeout: float = 300.0,
                     mesh=None, **model_cfg: Any) -> PoolPath:
    """A warmed pool on `model` (at `MODEL_CFG[model]`, its fields
    overridden by `model_cfg`, e.g. `compute_dtype`) with `tenants`
    tenants of `devices` devices each (tenant i: weights and simulator
    from seed SEED + i), sharded over `mesh` if one is given."""
    scorer = build_model(model, **{**MODEL_CFG[model], **model_cfg})
    window = scorer.cfg.window
    metrics = MetricsRegistry()
    pool = SharedScoringPool(scorer, metrics,
                             PoolConfig(batch_buckets=buckets, seed=SEED),
                             mesh=mesh)
    members = {}
    arrived = asyncio.Event()
    for i in range(tenants):
        tid = f"{prefix}{i}"
        sim_cfg = SimConfig(num_devices=devices, seed=SEED + i)
        sim = DeviceSimulator(sim_cfg, tenant_id=tid)
        member = PoolTenant(filled_store(sim, devices, window), sim, sim_cfg,
                            scorer.init(torch.Generator().manual_seed(SEED + i)))

        async def deliver(scored, member=member):
            member.delivered.append(scored)
            arrived.set()

        pool.register(tid, member.store, THRESHOLD, deliver,
                      params=member.params)
        members[tid] = member
    deadline = time.monotonic() + timeout
    while not pool.ready:
        if time.monotonic() > deadline:
            raise TimeoutError(f"pool warmup not done in {timeout} s")
        await asyncio.sleep(0.01)
    return PoolPath(scorer, metrics, pool, members, TICK_S * (window + 4),
                    arrived)
