"""Shared multi-tenant scoring pool: one stacked dispatch scores every tenant.

The per-tenant `ScoringSession` (server.py) gives each tenant its own
ring and its own flush cadence — right for a handful of big tenants,
wasteful for many small ones (N dispatches per window). This pool is the
other operating point, and the default serving path (the megabatch):

- all tenants of one model architecture share a `TenantStack` (stacked
  params) and one stacked ring — `StackedStreamingRing` for a streaming
  model (one cell step per event), `StackedDeviceRing` otherwise —
  resident on one device;
- admissions from every tenant land in per-tenant queues; one flusher
  with one admission deadline drains them together;
- each flush round uploads only `[T_cap, B]` (device id, value) deltas,
  runs ONE stacked update+score dispatch per occurrence round, and
  settles the result off the event loop (the dedicated session's
  pipelined settle), then fans results back out to each tenant's
  deliver callback concurrently.

Shapes stay bounded: the tenant axis is the stack's pow2 capacity, the
batch axis is bucketed (`batch_buckets`), and ragged per-tenant batches
pad into each tenant's scratch row. Param hot-swap writes one stack slot
in place on the dispatch stream (parallel/tenant_stack.py says why that
is safe) and `_flush_round` snapshots per-tenant versions at dispatch,
so every settled batch is attributed to the weights that scored it.

Over a mesh (`parallel/mesh.py`, `mesh=`) the stack and the ring are
sharded — tenant rows over `model`, batch columns over `data` — and a
dispatch runs one block a mesh position (`scoring/stream.py`
`MeshRing`); buckets round up to a data-axis multiple. `mesh_stats()`
reports the mesh's devices and shape (0 and `{}` meshless), and
admission consults the `scoring.mesh` chaos seam. A meshed dispatch
that fails marks the ring faulted and reseeds it, as meshless.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

import numpy as np

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch, ScoredBatch
from sitewhere_tpu_torch.kernel.egresslane import deliver_scored
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.kernel.tracing import NULL_TRACER
from sitewhere_tpu_torch.parallel.tenant_stack import TenantStack
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.ring import StackedDeviceRing
from sitewhere_tpu_torch.scoring.settle import SETTLE_POOL
from sitewhere_tpu_torch.scoring.stream import (
    MeshRing,
    StackedStreamingRing,
    result_ready,
    result_to_host,
    sparse_rows,
    start_to_host,
)
from sitewhere_tpu_torch.utils import resolve_device
from sitewhere_tpu_torch.utils.retry import retry_backoff

logger = logging.getLogger(__name__)

Deliver = Callable[[ScoredBatch], Awaitable[None]]


@dataclass(frozen=True)
class PoolConfig:
    batch_buckets: tuple[int, ...] = (256, 1024, 4096)
    batch_window_ms: float = 2.0
    mtype: int = 0
    seed: int = 0
    max_inflight: int = 64
    # per-tenant admission backlog (events) before that tenant's slot
    # reports `backlogged`; 0 → 4 × batch_buckets[-1]
    backlog_cap: int = 0
    # flush-path score readback dtype (see ScoringConfig.score_dtype)
    score_dtype: str = "float16"
    # sparse anomaly readback (see ScoringConfig.readback): the pooled
    # form uses per-tenant thresholds as a runtime [T] vector
    readback: str = "full"
    sparse_k: int = 0
    # megabatch window: how long the flusher holds an open megabatch for
    # more tenants' columns; 0 → batch_window_ms
    megabatch_window_ms: float = 0.0
    # tenants packed into one stacked dispatch; 0 = every due tenant.
    # The stack always computes all T_cap rows, so this bounds host-side
    # packing work and readback width, not device work — leftover
    # tenants flush in the immediately following round.
    max_tenants: int = 0
    # adaptive megabatch window: the live close deadline floats in
    # [window_s, WINDOW_SPAN × window_s], keyed to the active-tenant
    # count vs the observed tenants-per-dispatch occupancy; `window_s`
    # stays the floor, so the configured latency budget is never undercut
    window_auto: bool = True

    @property
    def backlog_events(self) -> int:
        return self.backlog_cap or 4 * self.batch_buckets[-1]

    @property
    def window_s(self) -> float:
        """Effective megabatch close deadline in seconds."""
        return (self.megabatch_window_ms or self.batch_window_ms) / 1e3


@dataclass
class _TenantEntry:
    tenant_id: str
    telemetry: TelemetryStore
    threshold: float
    deliver: Deliver
    # (device_index, value, ts, ingest, ctx, admit_monotonic)
    pending: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                        BatchContext, float]] = field(default_factory=list)
    pending_n: int = 0
    inflight: int = 0          # this tenant's share of in-flight flushes
    # a platform tenant (a forecaster's or a replay's slot): scores
    # through the same path but does not count as customer traffic in
    # the adaptive window tuner's active-tenant view
    internal: bool = False


class TenantSlot:
    """Per-tenant handle; mirrors the `ScoringSession` admission surface
    so a consumer loop treats both the same way — including
    `flush_due`/`flush_nowait`, which delegate to the POOL-wide megabatch
    state (consumer turns drive flush rounds; the background flusher only
    backstops idle-period deadlines)."""

    def __init__(self, pool: "SharedScoringPool", tenant_id: str):
        self.pool = pool
        self.tenant_id = tenant_id
        self.scored_meter = pool.scored_meter
        self.latency = pool.latency
        # stage decomposition is pool-wide, exposed per slot so pooled and
        # dedicated sinks present the same surface
        self.stage_admit = pool.stage_admit
        self.stage_batch = pool.stage_batch
        self.stage_device = pool.stage_device
        self.stage_sink = pool.stage_sink

    @property
    def ready(self) -> bool:
        return self.pool.ready

    @property
    def flush_due(self) -> bool:
        return self.pool.flush_due

    def flush_nowait(self) -> bool:
        return self.pool.flush_nowait()

    @property
    def flush_wait_s(self) -> float:
        return self.pool.flush_wait_s

    @property
    def pending_n(self) -> int:
        entry = self.pool.tenants.get(self.tenant_id)
        return entry.pending_n if entry is not None else 0

    @property
    def backlogged(self) -> bool:
        """This tenant's admission backlog is at capacity; its consumer
        must pause polling (backpressure, not post-consume drops)."""
        return self.pending_n >= self.pool.cfg.backlog_events

    @property
    def inflight(self) -> int:
        entry = self.pool.tenants.get(self.tenant_id)
        return entry.inflight if entry is not None else 0

    @property
    def dispatch_count(self) -> int:
        return self.pool.dispatch_count

    @property
    def settled_count(self) -> int:
        return self.pool.settled_count

    @property
    def settled_through(self) -> int:
        return self.pool.settled_through

    @property
    def idle(self) -> bool:
        """Nothing of THIS tenant pending or in flight (other tenants'
        load must not starve this tenant's commits or stop)."""
        return self.pending_n == 0 and self.inflight == 0

    async def drain(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.idle and time.monotonic() < deadline:
            await asyncio.sleep(0.01)

    @property
    def version(self) -> int:
        return self.pool.stack.versions.get(self.tenant_id, 0)

    def admit(self, batch: MeasurementBatch) -> None:
        self.pool.admit(self.tenant_id, batch)

    def admit_columns(self, device_index: np.ndarray, value: np.ndarray,
                      ts: np.ndarray, ctx: BatchContext) -> None:
        self.pool.admit_columns(self.tenant_id, device_index, value, ts, ctx)

    def swap_params(self, params: dict) -> int:
        version = self.pool.stack.set_params(self.tenant_id, params)
        if self.pool.streaming:
            # streaming state (h/c/pred) is a function of the weights —
            # reseed this tenant's rows from its host history under the
            # slot just written, as ScoringSession.swap_params does
            self.pool._seed_tenant_ring(
                self.tenant_id, self.pool.stack.slots[self.tenant_id],
                self.pool.tenants[self.tenant_id].telemetry)
        return version

    def reload_history(self) -> None:
        """Re-seed this tenant's ring slice from its host store (bulk
        imports that bypassed admit) — mirrors ScoringSession's."""
        entry = self.pool.tenants[self.tenant_id]
        self.pool._seed_tenant_ring(self.tenant_id,
                                    self.pool.stack.slots[self.tenant_id],
                                    entry.telemetry)


class SharedScoringPool:
    """One stack + one ring + one flusher for every tenant of one model
    architecture, on `device` (the card unless named)."""

    def __init__(self, model, metrics: MetricsRegistry,
                 cfg: PoolConfig = PoolConfig(), mesh=None, tracer=None,
                 faults=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # chaos seam ("scoring.megabatch"): consulted at admission — the
        # one pool surface reached from inside a consumer loop's
        # per-record quarantine, so an injected fault dead-letters the
        # offending record instead of crashing the flusher task
        self.faults = faults
        self.stack = TenantStack(model, mesh=mesh, seed=cfg.seed,
                                 device=self.device)
        self.mesh = mesh
        self.ring = None  # created on first register
        self.tenants: dict[str, _TenantEntry] = {}
        self.ready = True          # flips False while capacity warms up
        self.inflight = 0
        self.dispatch_count = 0
        self.settled_count = 0
        self._outstanding: set[int] = set()   # dispatched, not yet settled
        # strong refs to in-flight settle tasks: the loop keeps only weak
        # ones, and a GC'd settle leaves `inflight`/`_outstanding` stuck
        self._settle_tasks: set = set()
        self._pending_max = -1     # highest device index waiting
        self._wake = asyncio.Event()
        self._deadline: Optional[float] = None
        self._flusher: Optional[asyncio.Task] = None
        self._warmup: Optional[asyncio.Task] = None
        self._warmed_key: tuple = ()
        self.scored_meter = metrics.meter("scoring.events_scored")
        self.latency = metrics.histogram("scoring.e2e_latency_s")
        self.batch_latency = metrics.histogram("scoring.batch_latency_s")
        self.anomalies = metrics.counter("scoring.anomalies_detected")
        self.anomaly_overflow = metrics.counter("scoring.anomaly_overflow")
        self.flush_rounds = metrics.counter("scoring.pool_flush_rounds")
        self.dropped = metrics.counter("scoring.admissions_dropped")
        self.sink_failures = metrics.counter("scoring.sink_failures")
        # `scoring.dispatches` is the same registry counter the dedicated
        # session incs (instance-wide dispatch rate); megabatch_dispatches
        # counts only stacked dispatches; tenants_per_dispatch shows the
        # cross-tenant aggregation each flush round achieved;
        # stack_rebuilds surfaces capacity growths (each behind the
        # warmup gate)
        self.dispatches = metrics.counter("scoring.dispatches")
        self.megabatch_dispatches = metrics.counter(
            "scoring.megabatch_dispatches")
        self.megabatch_tenants = metrics.histogram(
            "scoring.megabatch_tenants_per_dispatch",
            buckets=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0])
        self.stack_rebuilds = metrics.counter("scoring.stack_rebuilds")
        self._rebuilds_seen = 0
        # latency decomposition, pool-wide (ScoringSession's stages)
        self.stage_admit = metrics.histogram("scoring.stage_admit_s")
        self.stage_batch = metrics.histogram("scoring.stage_batch_s")
        self.stage_device = metrics.histogram("scoring.stage_device_s")
        self.stage_sink = metrics.histogram("scoring.stage_sink_s")
        # per-pool gauges (one pool per model architecture): the devices
        # the stacked dispatch spans (0 = one, unsharded), tenant-row
        # occupancy, a live per-device model-throughput estimate, and the
        # adaptive window's live close deadline
        self.mesh_gauge = metrics.gauge(f"scoring.mesh_devices:{model.name}")
        self.mesh_gauge.set(mesh.size if mesh is not None else 0)
        self.occupancy_gauge = metrics.gauge(
            f"scoring.mesh_row_occupancy:{model.name}")
        self.tflops_gauge = metrics.gauge(
            f"scoring.model_tflops_per_device:{model.name}")
        # EMA over per-dispatch device throughput (α=0.2, ~5 dispatches)
        self._tflops_ema = 0.0
        self._window_s = cfg.window_s
        self.window_adjusts = metrics.counter(
            "scoring.megabatch_window_adjusts")
        self.window_gauge = metrics.gauge(
            f"scoring.megabatch_window_ms:{model.name}")
        self.window_gauge.set(self._window_s * 1e3)
        # window-tuner observation state: tenants that ADMITTED since the
        # last evaluation + the packed-tenant sum over the period
        self._tuner_tenants: set[str] = set()
        self._packed_sum = 0.0
        self._rounds_since_adjust = 0

    @property
    def settled_through(self) -> int:
        """Commit barrier: every dispatch with seq < this has settled."""
        return min(self._outstanding) if self._outstanding else self.dispatch_count

    # -- live telemetry -----------------------------------------------------

    def _note_device_throughput(self, n_events: int,
                                device_s: float) -> None:
        """Fold one settled dispatch into the live model-throughput
        estimate (per-dispatch view; under pipelining dispatches overlap,
        so the wall-clock rate stays the ground truth)."""
        flops_ev = float(getattr(self.model, "flops_per_event",
                                 lambda: 0.0)())
        if device_s <= 0.0 or n_events <= 0 or flops_ev <= 0.0:
            return
        devices = max(self.mesh.size if self.mesh is not None else 1, 1)
        tflops = n_events * flops_ev / device_s / 1e12 / devices
        self._tflops_ema = (tflops if self._tflops_ema == 0.0
                            else 0.8 * self._tflops_ema + 0.2 * tflops)
        self.tflops_gauge.set(round(self._tflops_ema, 6))

    def mesh_stats(self) -> dict:
        """The stacked dispatch's live telemetry (beat sample `mesh`
        block, worker heartbeat `signals.mesh`, fleet observer occupancy
        matrix): the mesh's devices and per-axis shape (0 and `{}`
        meshless), tenant-row occupancy, the adaptive window's live
        deadline and the per-device throughput EMA."""
        cap = int(self.stack.capacity)
        rows = len(self.tenants)
        occupancy = round(rows / cap, 4) if cap else 0.0
        self.occupancy_gauge.set(occupancy)
        return {
            "model": self.model.name,
            "devices": int(self.mesh.size) if self.mesh is not None else 0,
            "shape": ({str(k): int(v) for k, v in self.mesh.shape.items()}
                      if self.mesh is not None else {}),
            "tenant_rows": rows,
            "row_capacity": cap,
            "row_occupancy": occupancy,
            "window_ms_live": round(self._window_s * 1e3, 3),
            "dispatches": int(self.dispatch_count),
            "inflight": int(self.inflight),
            "model_tflops_per_device": round(self._tflops_ema, 5),
        }

    # -- registration -------------------------------------------------------

    def register(self, tenant_id: str, telemetry: TelemetryStore,
                 threshold: float, deliver: Deliver,
                 params: Optional[dict] = None,
                 internal: bool = False) -> TenantSlot:
        if tenant_id in self.tenants:
            raise ValueError(f"tenant {tenant_id!r} already registered")
        slot = self.stack.add_tenant(tenant_id, params)
        self.tenants[tenant_id] = _TenantEntry(
            tenant_id, telemetry, threshold, deliver, internal=internal)
        host = telemetry.channels.get(self.cfg.mtype)
        host_cap = host.capacity if host is not None else 1024
        if self.ring is None:
            self.ring = self._new_ring(host_cap)
        else:
            self.ring.ensure(self.stack.capacity, host_cap - 1)
            self.ring.clear_tenant(slot)  # a reused slot must not leak history
        self._seed_tenant_ring(tenant_id, slot, telemetry)
        self._note_rebuilds()
        self._ensure_started()
        if self._current_key() != self._warmed_key:
            self._start_warmup()
        return TenantSlot(self, tenant_id)

    @property
    def streaming(self) -> bool:
        return bool(getattr(self.model, "streaming", False))

    def _new_ring(self, device_cap: int):
        """Stacked window ring (per-event W-step rescan) or stacked
        streaming ring (one model step per event) — the model declares
        which hot path it wants, as for the dedicated session."""
        sparse = self.streaming and self.cfg.readback == "anomalies"
        if self.cfg.readback == "anomalies" and not self.streaming:
            logger.warning("readback='anomalies' needs a streaming "
                           "model; %s uses the stacked window ring — "
                           "full readback", type(self.model).__name__)
        if self.mesh is not None:
            # one meshless ring a (model shard, device), each dense; the
            # mesh ring narrows and selects (sparse) over whole rows
            if self.streaming:
                def make(rows, cap, device, score_dtype):
                    return StackedStreamingRing(
                        self.model, rows, device_cap=cap,
                        score_dtype=score_dtype, device=device)
            else:
                def make(rows, cap, device, score_dtype):
                    return StackedDeviceRing(
                        self.model.cfg.window, rows, device_cap=cap,
                        score_dtype=score_dtype, device=device)
            return MeshRing(self.mesh, make, self.stack.capacity,
                            device_cap=device_cap,
                            score_dtype=self.cfg.score_dtype,
                            sparse=sparse, sparse_k=self.cfg.sparse_k)
        if self.streaming:
            return StackedStreamingRing(
                self.model, self.stack.capacity, device_cap=device_cap,
                score_dtype=self.cfg.score_dtype, sparse=sparse,
                sparse_k=self.cfg.sparse_k, device=self.device)
        return StackedDeviceRing(
            self.model.cfg.window, self.stack.capacity,
            device_cap=device_cap, score_dtype=self.cfg.score_dtype,
            device=self.device)

    def _seed_tenant_ring(self, tenant_id: str, slot: int,
                          telemetry: TelemetryStore) -> None:
        host = telemetry.channels.get(self.cfg.mtype)
        if host is None:
            return
        w = self.model.cfg.window
        x, _ = host.window(np.arange(host.capacity), w)
        cnt = np.minimum(host.count, w)
        if self.streaming:
            # streaming state is a function of this tenant's WEIGHTS —
            # seed by replaying its host windows under its own slot
            self.ring.load_tenant(slot, x, cnt,
                                  self.stack.get_params(tenant_id))
        else:
            self.ring.load_tenant(slot, x, cnt)

    def unregister(self, tenant_id: str) -> None:
        entry = self.tenants.pop(tenant_id, None)
        slot = self.stack.slots.get(tenant_id)
        if slot is not None and self.ring is not None:
            self.ring.clear_tenant(slot)
        self.stack.remove_tenant(tenant_id)
        if entry is not None and entry.pending_n:
            self.dropped.inc(entry.pending_n)

    def _ensure_started(self) -> None:
        if self._flusher is None or self._flusher.done():
            self._flusher = asyncio.create_task(
                self._run(), name=f"scoring-pool/{self.model.name}")

    # -- warmup -------------------------------------------------------------

    def _current_key(self) -> tuple:
        return (self.stack.capacity,
                self.ring.t_cap if self.ring else 0,
                self.ring.device_cap if self.ring else 0)

    def _start_warmup(self) -> None:
        if self._warmup is not None and not self._warmup.done():
            self._warmup.cancel()
        self.ready = False
        self._warmup = asyncio.create_task(
            self._warm_async(), name=f"scoring-pool/{self.model.name}/warmup")

    def _dispatch(self, dev: np.ndarray, val: np.ndarray):
        """One stacked update+score dispatch on `[T_cap, b]` columns."""
        if getattr(self.ring, "sparse", False):
            return self.ring.update_and_score(
                self.model, self.stack.stacked, dev, val,
                thresholds=self._thresholds())
        return self.ring.update_and_score(
            self.model, self.stack.stacked, dev, val)

    async def _warm_async(self) -> None:
        """Run every batch bucket once at the current capacities off the
        hot path (allocator growth, first launches); flushes are held (and
        backlog capped) meanwhile. A failure must not stall the pool
        forever: recover the ring and retry with backoff. If capacities
        grow mid-warmup, the attempt restarts at the new shapes."""

        async def attempt():
            while True:
                key = self._current_key()
                for b in (self.stack.pad_batch(b0)
                          for b0 in self.cfg.batch_buckets):
                    dev = np.full((self.ring.t_cap, b), self.ring.device_cap,
                                  np.int32)
                    v = np.zeros((self.ring.t_cap, b), np.float32)
                    out = start_to_host(self._dispatch(dev, v))
                    while not result_ready(out):
                        await asyncio.sleep(0.01)
                    if self._current_key() != key:
                        break  # grew mid-warmup; warm the new shapes
                else:
                    self._warmed_key = key
                    return

        await retry_backoff(
            attempt, lambda: self._recover_ring(restart_warmup=False),
            logger, "pool warmup")
        self.ready = True
        self._wake.set()

    # -- admission ----------------------------------------------------------

    def admit(self, tenant_id: str, batch: MeasurementBatch) -> None:
        entry = self.tenants[tenant_id]
        if self.faults is not None:
            # sync check: a raised fault propagates to the admitting
            # consumer's per-record quarantine; nothing was taken yet
            self.faults.check("scoring.megabatch")
            if self.mesh is not None:
                # the mesh-sharded dispatch's own chaos seam: same
                # quarantine contract, armed only on a mesh
                self.faults.check("scoring.mesh")
        mask = batch.mtype == self.cfg.mtype
        if mask.all():
            dev, val, ts = batch.device_index, batch.value, batch.ts
        else:
            dev, val, ts = (batch.device_index[mask], batch.value[mask],
                            batch.ts[mask])
        if dev.shape[0] == 0:
            return
        now = time.monotonic()
        self.stage_admit.observe(now - batch.ctx.ingest_monotonic)
        if self.cfg.window_auto and not entry.internal:
            # window tuner: live customer traffic only
            self._tuner_tenants.add(tenant_id)
        ingest = np.full(dev.shape[0], batch.ctx.ingest_monotonic)
        entry.pending.append((dev, val, ts, ingest, batch.ctx, now))
        entry.pending_n += dev.shape[0]
        self._pending_max = max(self._pending_max, int(dev.max()))
        if self._deadline is None:
            # the LIVE window: the tuner floats it above the floor
            self._deadline = time.monotonic() + self._window_s
        self._wake.set()

    def admit_columns(self, tenant_id: str, device_index: np.ndarray,
                      value: np.ndarray, ts: np.ndarray,
                      ctx: BatchContext) -> None:
        """Column-block admission for internal callers (a replay): the
        columns are already mtype-filtered, so no MeasurementBatch
        wrapper, no mask pass, no admit-stage latency sample (a replayed
        event's ingest time is its original one) and no window-tuner
        vote. Live ingress goes through admit()."""
        entry = self.tenants[tenant_id]
        if self.faults is not None:
            self.faults.check("scoring.megabatch")
            if self.mesh is not None:
                self.faults.check("scoring.mesh")
        n = device_index.shape[0]
        if n == 0:
            return
        now = time.monotonic()
        entry.pending.append((device_index, value, ts,
                              np.full(n, ctx.ingest_monotonic), ctx, now))
        entry.pending_n += n
        self._pending_max = max(self._pending_max, int(device_index.max()))
        if self._deadline is None:
            self._deadline = time.monotonic() + self._window_s
        self._wake.set()

    # -- flushing -----------------------------------------------------------

    @property
    def _total_pending(self) -> int:
        return sum(e.pending_n for e in self.tenants.values())

    def _note_rebuilds(self) -> None:
        """Publish stack capacity growths since the last look as the
        `scoring.stack_rebuilds` counter."""
        d = self.stack.rebuilds - self._rebuilds_seen
        if d > 0:
            self.stack_rebuilds.inc(d)
            self._rebuilds_seen = self.stack.rebuilds

    def _thresholds(self) -> np.ndarray:
        """Per-slot alert bars for the sparse step ([T_cap] f32); empty
        slots get +inf so they can never report."""
        th = np.full(self.ring.t_cap, np.inf, np.float32)
        for tid, e in self.tenants.items():
            slot = self.stack.slots.get(tid)
            if slot is not None and slot < th.shape[0]:
                th[slot] = e.threshold
        return th

    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.batch_buckets:
            if n <= b:
                return self.stack.pad_batch(b)
        return self.stack.pad_batch(self.cfg.batch_buckets[-1])

    # -- adaptive megabatch window ------------------------------------------

    # widen at most to 8× the configured floor; adjust geometrically, at
    # most once per 16 flush rounds, and only OUTSIDE the [0.5, 0.9]
    # occupancy band — the hysteresis gap that makes the tuner converge
    # instead of flapping between widen and narrow
    WINDOW_SPAN = 8.0
    WINDOW_ADJUST_EVERY = 16

    def _tune_window(self, packed: int) -> None:
        """Fold one closed megabatch's occupancy into the window tuner:
        every WINDOW_ADJUST_EVERY rounds, compare the mean
        tenants-per-dispatch with the tenants that actually admitted in
        the period. Under-packed periods widen the window so aggregation
        recovers; near-full periods narrow it back toward the floor."""
        if not self.cfg.window_auto:
            return
        self._packed_sum += packed
        self._rounds_since_adjust += 1
        if self._rounds_since_adjust < self.WINDOW_ADJUST_EVERY:
            return
        active = len(self._tuner_tenants)
        if self.cfg.max_tenants:
            active = min(active, self.cfg.max_tenants)
        mean_packed = self._packed_sum / self._rounds_since_adjust
        self._packed_sum = 0.0
        self._rounds_since_adjust = 0
        self._tuner_tenants.clear()
        if active <= 1:
            return  # one live tenant: nothing to aggregate, floor holds
        frac = mean_packed / active
        base = self.cfg.window_s
        if frac < 0.5 and self._window_s < base * self.WINDOW_SPAN:
            self._window_s = min(self._window_s * 1.5,
                                 base * self.WINDOW_SPAN)
        elif frac > 0.9 and self._window_s > base:
            self._window_s = max(self._window_s * 0.67, base)
        else:
            return  # in the hysteresis band (or pinned at a bound): hold
        self.window_adjusts.inc()
        self.window_gauge.set(self._window_s * 1e3)

    @property
    def flush_due(self) -> bool:
        """The megabatch is ready to close: pending work, warmed, under
        the inflight cap, and either the window expired or waiting can no
        longer improve the pack — every registered tenant (up to
        `max_tenants`) already holds a full bucket's take."""
        if not self.ready or self._total_pending == 0:
            return False
        if self.inflight >= self.cfg.max_inflight:
            return False  # backpressure: let settles catch up
        if time.monotonic() >= (self._deadline or 0.0):
            return True
        bucket = self.cfg.batch_buckets[-1]
        quota = len(self.tenants)
        if self.cfg.max_tenants:
            quota = min(quota, self.cfg.max_tenants)
        full = sum(1 for e in self.tenants.values()
                   if e.pending_n >= bucket)
        return quota > 0 and full >= quota

    @property
    def flush_wait_s(self) -> float:
        """How long a consumer poll may wait before the megabatch
        deadline (ScoringSession.flush_wait_s's contract)."""
        if self._total_pending == 0 or not self.ready:
            return 0.2
        if self.inflight >= self.cfg.max_inflight:
            return 0.005
        return max((self._deadline or 0.0) - time.monotonic(), 0.0)

    def flush_nowait(self) -> bool:
        """Close and dispatch the due megabatch now, draining the WHOLE
        pending backlog in bucket-sized stacked rounds back to back (the
        inflight cap gates starting a flush, not its rounds). Returns
        False when nothing was due or a regrow held the round."""
        if not self.flush_due:
            return False
        if (self._pending_max >= self.ring.device_cap
                or self.stack.capacity != self.ring.t_cap):
            # a pending event outgrew the ring (or the stack grew): grow
            # and re-warm off the hot path; the ready gate holds flushes.
            # This also keeps every id in range before any launch.
            self.ring.ensure(self.stack.capacity, self._pending_max)
            self._start_warmup()
            return False
        self._deadline = None
        while self._total_pending > 0:  # no awaits: admission can't race
            self.flush_rounds.inc()
            self._flush_round()
        # a multi-round drain re-arms the deadline for its own leftovers;
        # clear it so the NEXT admission opens a fresh window
        self._deadline = None
        return True

    async def _run(self) -> None:
        while True:
            timeout = 0.2
            if self.ready and self._deadline is not None:
                timeout = max(self._deadline - time.monotonic(), 0.0)
            try:
                await asyncio.wait_for(self._wake.wait(), timeout)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            if not self.ready or self._total_pending == 0:
                continue
            if self.inflight >= self.cfg.max_inflight:
                await asyncio.sleep(0.005)
                self._wake.set()
                continue
            self.flush_nowait()

    def _take(self, tid: str, e: _TenantEntry) -> tuple:
        """One tenant's take: whole admitted batches up to the bucket
        budget, splitting only a lone oversized head batch; a boundary
        batch that does not fit ends the take and re-queues with its own
        ctx."""
        taken: list[tuple] = []
        traces = []
        budget = self.cfg.batch_buckets[-1]
        now = time.monotonic()
        while e.pending and budget > 0:
            p = e.pending[0]
            n = p[0].shape[0]
            if n <= budget:
                e.pending.pop(0)
                taken.append(p)
                traces.append((p[4].trace_id, n, p[5]))
                budget -= n
            elif not taken:
                head = tuple(c[:budget] for c in p[:4]) + (p[4], p[5])
                e.pending[0] = tuple(c[budget:] for c in p[:4]) + (p[4], p[5])
                taken.append(head)
                traces.append((p[4].trace_id, budget, p[5]))
                budget = 0
            else:
                # end the take at the batch boundary instead of shearing
                # the next batch (a sheared head drags duplicates in)
                break
            self.stage_batch.observe(now - p[5])
        e.pending_n = sum(p[0].shape[0] for p in e.pending)
        if e.pending_n:
            self._wake.set()
            if self._deadline is None:
                self._deadline = time.monotonic()
        dev = np.concatenate([p[0] for p in taken])
        val = np.concatenate([p[1] for p in taken])
        ts = np.concatenate([p[2] for p in taken])
        ing = np.concatenate([p[3] for p in taken])
        # the take's delivery ctx: exact for one batch, merged sources
        # for several (the dedicated session's _take_pending convention)
        sources = {p[4].source for p in taken}
        ctx = taken[0][4] if len(sources) == 1 else BatchContext(
            tenant_id=tid, source="+".join(sorted(sources)),
            ingest_monotonic=min(p[4].ingest_monotonic for p in taken))
        return dev, val, ts, ing, traces, ctx

    def _flush_round(self) -> None:
        """Close the megabatch: take up to one bucket of rows from every
        due tenant (at most `max_tenants`), pack them into stacked
        `[T_cap, B]` columns and dispatch ONE stacked call per occurrence
        round (events for the same device within a take are applied and
        scored in arrival order, so a coalesced backlog scores like
        per-tick flushes), then schedule the settle. Leftovers re-queue
        and the wake stays set so the next round follows at once.

        Version fence: per-tenant versions are snapshotted here, at
        dispatch, and ride the metas into the settle — a hot swap or
        register/unregister landing while this megabatch is in flight
        can never claim its scores."""
        self._note_rebuilds()
        takes: dict[str, tuple] = {}
        max_t = self.cfg.max_tenants
        with self.tracer.span("scoring.pool_take"):
            for tid, e in self.tenants.items():
                if e.pending_n == 0:
                    continue
                if max_t and len(takes) >= max_t:
                    # tenants past the per-dispatch bound ride the next
                    # round, immediately (wake + hot deadline)
                    self._wake.set()
                    if self._deadline is None:
                        self._deadline = time.monotonic()
                    break
                takes[tid] = self._take(tid, e)
        if self._total_pending == 0:
            self._pending_max = -1
        if not takes:
            return
        t_cap, d_cap = self.ring.t_cap, self.ring.device_cap

        # split every tenant's take into occurrence rounds
        # meta: (tid, slot, n, dev, ts, ing, traces, ev_rounds, ctx,
        #        version-at-dispatch)
        metas = []
        round_parts: list[list[tuple[int, np.ndarray, np.ndarray]]] = []
        for tid, (dev, val, ts, ing, traces, ctx) in takes.items():
            slot = self.stack.slots[tid]
            n = dev.shape[0]
            ev_rounds = []
            # O(n) duplicate-free fast path before the O(n log n) split: a
            # strictly-ascending take needs no occurrence split at all
            if n < 2 or bool((dev[1:] > dev[:-1]).all()):
                parts = [(dev, val, None)]
            else:
                order = np.argsort(dev, kind="stable")
                sd, sv = dev[order], val[order]
                _, start, cnts = np.unique(sd, return_index=True,
                                           return_counts=True)
                if int(cnts.max()) == 1:
                    parts = [(dev, val, None)]
                else:
                    cum = np.arange(n) - np.repeat(start, cnts)
                    parts = [(sd[cum == r], sv[cum == r], order[cum == r])
                             for r in range(int(cum.max()) + 1)]
            for r, (rdev, rval, rpos) in enumerate(parts):
                while len(round_parts) <= r:
                    round_parts.append([])
                round_parts[r].append((slot, rdev, rval))
                ev_rounds.append((r, rpos, rdev.shape[0]))
            metas.append((tid, slot, n, dev, ts, ing, traces, ev_rounds,
                          ctx, self.stack.versions.get(tid, 0)))

        t0 = time.monotonic()
        dispatches = []
        try:
            with self.tracer.span("scoring.dispatch",
                                  n_events=sum(m[2] for m in metas)):
                for parts in round_parts:
                    b = self._bucket_for(max(p[1].shape[0] for p in parts))
                    dev_in = np.full((t_cap, b), d_cap, np.int32)  # scratch pad
                    val_in = np.zeros((t_cap, b), np.float32)
                    for slot, rdev, rval in parts:
                        dev_in[slot, :rdev.shape[0]] = rdev
                        val_in[slot, :rdev.shape[0]] = rval
                    # start the device→host copy now (non-blocking): the
                    # settle thread then waits on this copy's event only
                    dispatches.append(start_to_host(
                        self._dispatch(dev_in, val_in)))
        except Exception:
            logger.exception("pool dispatch failed; reseeding ring")
            self.dropped.inc(sum(m[2] for m in metas))
            self._recover_ring()
            return
        self.dispatches.inc(len(dispatches))
        self.megabatch_dispatches.inc(len(dispatches))
        self.megabatch_tenants.observe(float(len(metas)))
        self._tune_window(len(metas))
        # every packed tenant's traces get a queue-wait span (its own
        # admit time → this stacked dispatch); the settle records the
        # shared device half per tenant
        for tid, _slot, _n, _dev, _ts, _ing, traces, *_ in metas:
            for trace_id, n_ev, t_admit in traces:
                self.tracer.record(trace_id, "rule-processing.dispatch", tid,
                                   t_admit, max(t0 - t_admit, 0.0), n_ev)
        self.inflight += 1
        seq = self.dispatch_count
        self.dispatch_count += 1
        self._outstanding.add(seq)
        for tid, *_ in metas:
            e = self.tenants.get(tid)
            if e is not None:
                e.inflight += 1
        task = asyncio.get_running_loop().create_task(
            self._settle_and_deliver(dispatches, metas, t0, seq))
        self._settle_tasks.add(task)
        task.add_done_callback(self._settle_task_done)

    def _settle_task_done(self, task) -> None:
        self._settle_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            # the settle's finally keeps the inflight accounting right
            # even here, but an escape is a bug: surface it
            logger.error("pool settle task died unexpectedly",
                         exc_info=task.exception())

    async def _settle_and_deliver(self, dispatches, metas, t0: float,
                                  seq: Optional[int] = None) -> None:
        loop = asyncio.get_running_loop()
        try:
            try:
                settled = await asyncio.gather(*[
                    loop.run_in_executor(SETTLE_POOL, result_to_host, s)
                    for s in dispatches])
            except BaseException as exc:
                self.dropped.inc(sum(m[2] for m in metas))
                if isinstance(exc, Exception):
                    logger.exception("pool settle failed")
                    return
                raise
            # the loop's own work of the settle; the fan-out below hands
            # each delivery to a task of its own and resumes only after
            # the loop has run whatever else was ready, so it stays out
            with self.tracer.span("scoring.settle",
                                  n_events=sum(m[2] for m in metas)):
                deliveries = self._scored_deliveries(settled, metas, t0)
            # fan-out through the one delivery contract (deliver_scored):
            # every tenant of the megabatch delivers concurrently, failures
            # counted and isolated per tenant
            if deliveries:
                await asyncio.gather(*[
                    deliver_scored(deliver, scored, self.sink_failures,
                                   self.stage_sink, label=f"tenant {tid}")
                    for tid, deliver, scored in deliveries])
        finally:
            self.inflight -= 1
            self.settled_count += 1
            if seq is not None:
                self._outstanding.discard(seq)
            for tid, *_ in metas:
                e = self.tenants.get(tid)
                if e is not None:
                    e.inflight = max(0, e.inflight - 1)

    def _scored_deliveries(self, settled, metas, t0: float) -> list:
        """The loop's half of a settle: the scores of each tenant of the
        megabatch assembled and counted, as `(tenant, deliver,
        ScoredBatch)` for the fan-out."""
        now = time.monotonic()
        self.batch_latency.observe(now - t0)
        self.stage_device.observe(now - t0)
        self._note_device_throughput(sum(m[2] for m in metas), now - t0)
        sparse = bool(settled) and isinstance(settled[0], tuple)
        deliveries: list[tuple[str, Deliver, ScoredBatch]] = []
        for (tid, slot, n, dev, ts, ing, traces, ev_rounds, ctx,
             version) in metas:
            e = self.tenants.get(tid)
            if e is None:  # unregistered mid-flight
                continue
            self.scored_meter.mark(n)
            self.latency.observe_array(now - ing)
            if sparse:
                # per-tenant anomalous subset: this tenant's row of
                # each round, remapped back to its take positions
                fpos, a_scores = sparse_rows(
                    ((tuple(a[slot] for a in settled[r]), k, rpos)
                     for r, rpos, k in ev_rounds), self.anomaly_overflow)
                self.anomalies.inc(int(fpos.shape[0]))
                scored = ScoredBatch(
                    ctx, dev[fpos], a_scores,
                    np.ones(fpos.shape[0], bool), ts[fpos],
                    # the version snapshotted at DISPATCH, not the
                    # live one
                    model_version=version, total_scored=n)
            else:
                scores = np.empty(n, np.float32)
                for r, rpos, k in ev_rounds:
                    if rpos is None:
                        scores[:k] = settled[r][slot, :k]
                    else:
                        scores[rpos] = settled[r][slot, :k]
                is_anom = scores >= e.threshold
                n_anom = int(is_anom.sum())
                if n_anom:
                    self.anomalies.inc(n_anom)
                scored = ScoredBatch(ctx, dev, scores, is_anom, ts,
                                     model_version=version)
            for trace_id, n_ev, *_ in traces:
                self.tracer.record(trace_id, "rule-processing.score", tid,
                                   t0, now - t0, n_ev)
            deliveries.append((tid, e.deliver, scored))
        return deliveries

    def _recover_ring(self, restart_warmup: bool = True) -> None:
        # a dispatch that failed mid-update leaves the ring inconsistent —
        # allocate fresh state FIRST, then reseed every tenant from its
        # host store
        self.ring = self._new_ring(
            self.ring.device_cap if self.ring else 1024)
        for tid, entry in self.tenants.items():
            try:
                self._seed_tenant_ring(tid, self.stack.slots[tid],
                                       entry.telemetry)
            except Exception:  # noqa: BLE001 - an empty ring still scores
                logger.exception("ring reseed failed for tenant %s", tid)
        if restart_warmup:
            self._warmed_key = ()
            self._start_warmup()

    async def drain(self, timeout: float = 30.0) -> None:
        deadline = time.monotonic() + timeout
        while ((self.inflight > 0 or self._total_pending > 0)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.01)

    def close(self) -> None:
        for task in (self._flusher, self._warmup):
            if task is not None and not task.done():
                task.cancel()
        self._flusher = self._warmup = None
        if self.ring is not None:
            self.ring.close()
