"""The scoring session: batched, bucketed, pipelined model inference.

One tenant's dedicated scorer, replacing per-event CPU rule evaluation
with scoring on the card:

- admission batching with a deadline: events accumulate for at most
  `batch_window_ms` (or until a full bucket) before a flush;
- fixed bucket shapes: batch sizes are padded up to a small set of
  buckets, each exercised at warmup, so no request pays a first-launch
  cost (kernel build, allocator growth);
- device-resident history: per-device windows (scoring/ring.py) or,
  for a streaming model, per-device model state (scoring/stream.py)
  live on the card; a flush uploads only (device id, value) deltas and
  one step appends + gathers + scores;
- pipelined settle: dispatch is asynchronous; each flush's scores start
  their copy to pinned host memory at dispatch, a small thread pool
  waits on each copy's own CUDA event, then delivery runs on the event
  loop via the session's `sink`.

`score_devices` (the query/test path) still gathers windows from the
host `TelemetryStore`; only admit/flush — the hot path — uses the ring.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch, ScoredBatch
from sitewhere_tpu_torch.kernel.egresslane import deliver_scored
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.kernel.tracing import NULL_TRACER
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.ring import DeviceRing
from sitewhere_tpu_torch.scoring.settle import SETTLE_POOL
from sitewhere_tpu_torch.scoring.stream import (
    StreamingRing,
    result_ready,
    result_to_host,
    sparse_rows,
    start_to_host,
)
from sitewhere_tpu_torch.utils import resolve_device
from sitewhere_tpu_torch.utils.retry import retry_backoff

logger = logging.getLogger(__name__)

Sink = Callable[[ScoredBatch], Awaitable[None]]


@dataclass(frozen=True)
class ScoringConfig:
    buckets: tuple[int, ...] = (256, 1024, 4096, 16384)
    batch_window_ms: float = 2.0
    threshold: float = 4.0          # z-like score ⇒ alert
    mtype: int = 0                  # channel scored
    seed: int = 0
    max_inflight: int = 64          # dispatched-not-settled flush bound
    capacity: int = 0               # fleet-size hint: pre-size the ring
    # admission backlog (events) before `backlogged` engages consumer
    # backpressure; 0 → 4 × buckets[-1] (a standing queue of B events
    # adds B/rate seconds of tail)
    backlog_cap: int = 0
    # flush-path score readback dtype: float16 halves the only per-event
    # device→host payload (z-like scores need ~3 significant digits);
    # "float32" restores exact readback
    score_dtype: str = "float16"
    # "full": every score ships device→host (exact per-event scores for
    # sinks and queries). "anomalies": threshold on the device and ship
    # only the anomalous (position, score) pairs (streaming models only;
    # see scoring/stream.streaming_step_sparse)
    readback: str = "full"
    # anomaly slots per flush in sparse mode; 0 → max(128, bucket/64).
    # Overflow is counted (scoring.anomaly_overflow), never silent.
    sparse_k: int = 0
    # cross-tenant megabatch handoff (scoring/pool.py): when the engine
    # routes through the shared pool these become its PoolConfig's close
    # deadline (0 → batch_window_ms), tenants-per-dispatch bound and
    # window tuner switch; a dedicated session ignores them
    megabatch_window_ms: float = 0.0
    megabatch_max_tenants: int = 0
    megabatch_autotune: bool = True

    @property
    def backlog_events(self) -> int:
        return self.backlog_cap or 4 * self.buckets[-1]


class ScoringSession:
    """One tenant's scorer: model + device-resident params & history ring
    + bucketed dispatch + admission queue, on `device` (the card unless
    named)."""

    def __init__(self, model, telemetry: TelemetryStore,
                 metrics: MetricsRegistry, cfg: ScoringConfig = ScoringConfig(),
                 params: Optional[dict] = None, sink: Optional[Sink] = None,
                 tracer=None, faults=None, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.telemetry = telemetry
        self.cfg = cfg
        self.sink = sink
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # chaos seam ("scoring.dispatch"): consulted before a flush takes
        # its pending admissions, so an injected crash loses nothing
        self.faults = faults
        self.params = self._place(
            params if params is not None
            else model.init(torch.Generator().manual_seed(cfg.seed)))
        self.version = 0
        host = telemetry.channels.get(cfg.mtype)
        self.ring = self._new_ring(max(
            cfg.capacity, host.capacity if host else 0, 1024))
        # False while warmup runs the buckets; flushes are held (admission
        # capped) so no live request pays a first-launch cost
        self.ready = True
        self.inflight = 0
        # monotonic flush progress: dispatch_count - settled_count ==
        # inflight; a consumer's commit checkpoint compares these
        self.dispatch_count = 0
        self.settled_count = 0
        self._outstanding: set[int] = set()   # dispatched, not yet settled
        # strong refs to in-flight settle tasks: the loop keeps only weak
        # ones, and a GC'd settle would leave `inflight` stuck forever
        self._settle_tasks: set = set()
        self._regrow_task: Optional[asyncio.Task] = None
        # pending admission state:
        # (device_index, value, ts, ingest, ctx, admit_monotonic)
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray, BatchContext, float]] = []
        self._pending_n = 0
        self._pending_max = -1      # highest device index waiting
        self._deadline: Optional[float] = None
        self.scored_meter = metrics.meter("scoring.events_scored")
        self.latency = metrics.histogram("scoring.e2e_latency_s")
        self.batch_latency = metrics.histogram("scoring.batch_latency_s")
        self.batch_size_hist = metrics.histogram(
            "scoring.batch_size", buckets=[float(b) for b in cfg.buckets])
        self.anomalies = metrics.counter("scoring.anomalies_detected")
        self.anomaly_overflow = metrics.counter("scoring.anomaly_overflow")
        self.dropped = metrics.counter("scoring.admissions_dropped")
        self.sink_failures = metrics.counter("scoring.sink_failures")
        # flush-path dispatches (one inc per fused update+score call —
        # chunks and occurrence rounds each count)
        self.dispatches = metrics.counter("scoring.dispatches")
        # end-to-end latency decomposition:
        #   admit  = receiver arrival → admission
        #   batch  = admission → dispatch (deadline batching + inflight gate)
        #   device = dispatch → scores on host (queue + compute + copy)
        #   sink   = settled → published
        self.stage_admit = metrics.histogram("scoring.stage_admit_s")
        self.stage_batch = metrics.histogram("scoring.stage_batch_s")
        self.stage_device = metrics.histogram("scoring.stage_device_s")
        self.stage_sink = metrics.histogram("scoring.stage_sink_s")

    def _place(self, params: dict) -> dict:
        return tree_map(lambda v: v.to(self.device), params)

    def _new_ring(self, capacity: int):
        """Window ring (raw history, per-event window rescore) or
        streaming ring (resident model state, one step per event) — the
        model declares which hot path it wants."""
        if getattr(self.model, "streaming", False):
            ring = StreamingRing(
                self.model, capacity=capacity,
                score_dtype=self.cfg.score_dtype,
                sparse_threshold=(self.cfg.threshold
                                  if self.cfg.readback == "anomalies"
                                  else None),
                sparse_k=self.cfg.sparse_k, device=self.device)
            ring.bind_params(self.params)
            return ring
        if self.cfg.readback == "anomalies":
            logger.warning("readback='anomalies' needs a streaming "
                           "model; %s uses the window ring — full "
                           "readback", type(self.model).__name__)
        return DeviceRing(self.model.cfg.window, capacity=capacity,
                          score_dtype=self.cfg.score_dtype, device=self.device)

    # -- warmup / params ---------------------------------------------------

    def _warm_dispatches(self):
        """Yield one device result per bucket and path: the fused
        update+score hot path and the host-window query path."""
        w = self.model.cfg.window
        dev = np.empty(0, np.int32)
        v = np.empty(0, np.float32)
        for b in self.cfg.buckets:
            yield start_to_host(self.ring.update_and_score(
                self.model, self.params, dev, v, b))
            yield start_to_host(self.model.score(
                self.params,
                torch.zeros((b, w), dtype=torch.float32, device=self.device),
                torch.ones((b, w), dtype=torch.bool, device=self.device)))

    def warmup(self) -> None:
        """Synchronous warmup: seed the ring from the host store (adopting
        its device capacity), then run every bucket once (tests / tools)."""
        self._load_ring()
        for out in self._warm_dispatches():
            result_to_host(out)
        self.ready = True

    async def warmup_async(self) -> None:
        """Background warmup with admission capped meanwhile. A failure
        must not hold `ready` False forever: recover the ring and retry
        with backoff."""
        self.ready = False

        async def attempt():
            self._load_ring()
            for out in self._warm_dispatches():
                while not result_ready(out):
                    await asyncio.sleep(0.01)

        def recover():
            self.ring = self._new_ring(self.ring.capacity)

        await retry_backoff(attempt, recover, logger, "scoring warmup")
        self.ready = True

    def _load_ring(self) -> None:
        """Seed/repair the device ring from the host store (one bulk
        upload)."""
        host = self.telemetry.channels.get(self.cfg.mtype)
        if host is None:
            return
        w = self.model.cfg.window
        devices = np.arange(host.capacity)
        x, _ = host.window(devices, w)
        self.ring.load(x, np.minimum(host.count, w))

    def reload_history(self) -> None:
        """Re-sync the device ring from the host store (bulk-import path:
        history that entered the store without passing through admit)."""
        self._load_ring()

    def swap_params(self, new_params: dict) -> int:
        """Hot-swap trained params (checkpoint rollout); bumps version."""
        self.params = self._place(new_params)
        if isinstance(self.ring, StreamingRing):
            # streaming state (h/c/pred) is a function of the weights —
            # carrying old-weight state into new-weight steps mis-scores
            # every device until it washes out. Reseed from host history.
            self.ring.bind_params(self.params)
            self._load_ring()
        self.version += 1
        return self.version

    # -- query-path scoring (host windows; not the hot path) ---------------

    def _bucket_for(self, n: int) -> int:
        for b in self.cfg.buckets:
            if n <= b:
                return b
        return self.cfg.buckets[-1]

    async def score_devices(self, devices: np.ndarray, ts: np.ndarray,
                            ingest_mono: np.ndarray,
                            ctx: BatchContext) -> ScoredBatch:
        """Score a set of devices from their *host-store* windows.

        The query/REST/test path: gathers `[D, W]` on host and ships it.
        Chunks are dispatched back-to-back and settled concurrently off
        the event loop."""
        if devices.shape[0] == 0:
            return ScoredBatch(ctx, devices, np.zeros(0, np.float32),
                               np.zeros(0, bool), ts, self.version)
        w = self.model.cfg.window
        max_b = self.cfg.buckets[-1]
        loop = asyncio.get_running_loop()
        settles = []
        for lo in range(0, devices.shape[0], max_b):
            chunk = devices[lo:lo + max_b]
            n = chunk.shape[0]
            bucket = self._bucket_for(n)
            x, valid = self.telemetry.window(chunk, w, mtype=self.cfg.mtype)
            if n < bucket:
                pad = bucket - n
                x = np.concatenate([x, np.zeros((pad, w), np.float32)])
                valid = np.concatenate([valid, np.zeros((pad, w), bool)])
            scores_dev = self.model.score(
                self.params, torch.from_numpy(x).to(self.device),
                torch.from_numpy(valid).to(self.device))
            self.batch_size_hist.observe(float(n))
            settles.append((loop.run_in_executor(
                SETTLE_POOL, result_to_host, start_to_host(scores_dev)), n))
        outs = [(await fut)[:n] for fut, n in settles]
        scores = np.concatenate(outs) if len(outs) > 1 else outs[0]
        now = time.monotonic()
        self.scored_meter.mark(devices.shape[0])
        self.latency.observe_array(now - ingest_mono)
        is_anom = scores >= self.cfg.threshold
        n_anom = int(is_anom.sum())
        if n_anom:
            self.anomalies.inc(n_anom)
        return ScoredBatch(ctx, devices, scores.astype(np.float32),
                           is_anom, ts, model_version=self.version)

    # -- admission batching (the hot path) ---------------------------------

    def admit(self, batch: MeasurementBatch) -> None:
        """Queue a measurement batch for the next flush.

        Sub-bucket admits coalesce within one batch window: the first
        admit into an empty queue opens the window (deadline = now +
        `batch_window_ms`), later admits join it without resetting the
        deadline, and `flush_due` holds until the window closes or a
        full bucket accumulates."""
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
        ingest = np.full(dev.shape[0], batch.ctx.ingest_monotonic)
        self._pending.append((dev, val, ts, ingest, batch.ctx, now))
        self._pending_n += dev.shape[0]
        self._pending_max = max(self._pending_max, int(dev.max()))
        if self._deadline is None:
            self._deadline = time.monotonic() + self.cfg.batch_window_ms / 1e3

    @property
    def pending_n(self) -> int:
        return self._pending_n

    @property
    def backlogged(self) -> bool:
        """Admission backlog is at capacity (warmup, regrows, sustained
        overload). The consumer must stop polling while this holds —
        backpressure, never dropping already-consumed events."""
        return self._pending_n >= self.cfg.backlog_events

    @property
    def idle(self) -> bool:
        """Nothing admitted, dispatched, or awaiting sink delivery."""
        return self._pending_n == 0 and self.inflight == 0

    @property
    def settled_through(self) -> int:
        """Every dispatch with seq < this value has settled or been
        accounted as dropped (settles may complete out of order)."""
        return min(self._outstanding) if self._outstanding else self.dispatch_count

    @property
    def flush_due(self) -> bool:
        if self._pending_n == 0 or not self.ready:
            return False
        if self.inflight >= self.cfg.max_inflight:
            return False  # backpressure: let settles catch up
        return (self._pending_n >= self.cfg.buckets[-1]
                or time.monotonic() >= (self._deadline or 0.0))

    @property
    def flush_wait_s(self) -> float:
        """How long a poll may wait before the admission deadline."""
        if self._pending_n == 0 or not self.ready:
            return 0.2
        if self.inflight >= self.cfg.max_inflight:
            return 0.005
        return max((self._deadline or 0.0) - time.monotonic(), 0.0)

    def _take_pending(self):
        pending, self._pending = self._pending, []
        self._pending_n, self._deadline = 0, None
        self._pending_max = -1
        now = time.monotonic()
        for p in pending:  # batching stage: admission → dispatch
            self.stage_batch.observe(now - p[5])
        if len(pending) == 1:
            # single-admit flush: pass the columns through with no copies
            dev, val, ts, ingest, ctx, t_admit = pending[0]
            return (dev, val.astype(np.float32, copy=False), ts, ingest,
                    ctx, [(ctx.trace_id, dev.shape[0], t_admit)])
        dev = np.concatenate([p[0] for p in pending])
        val = np.concatenate([p[1] for p in pending]).astype(np.float32, copy=False)
        ts = np.concatenate([p[2] for p in pending])
        ingest = np.concatenate([p[3] for p in pending])
        sources = {p[4].source for p in pending}
        ctx = pending[0][4] if len(sources) == 1 else BatchContext(
            tenant_id=pending[0][4].tenant_id, source="+".join(sorted(sources)),
            ingest_monotonic=min(p[4].ingest_monotonic for p in pending))
        traces = [(p[4].trace_id, p[0].shape[0], p[5]) for p in pending]
        return dev, val, ts, ingest, ctx, traces

    def _dispatch(self, dev, val):
        """Append + score on the device; returns a list of round dispatches
        `(result, n, positions)` whose scores map back to the original
        event positions.

        When a flush carries several events for one device, occurrences
        are applied AND scored in arrival order (one fused call per
        occurrence round), so every event's score reflects the device's
        window as of that event."""
        n = dev.shape[0]
        dev = dev.astype(np.int32, copy=False)
        self.ring.ensure_capacity(int(dev.max()))
        counts = np.unique(dev, return_counts=True)[1]
        if counts.max() == 1:
            rounds = [(dev, val, None)]  # identity mapping
        else:
            order = np.argsort(dev, kind="stable")
            sd, sv = dev[order], val[order]
            _, start, cnts = np.unique(sd, return_index=True, return_counts=True)
            cum = np.arange(n) - np.repeat(start, cnts)
            rounds = []
            for r in range(int(cum.max()) + 1):
                sel = cum == r
                rounds.append((sd[sel], sv[sel], order[sel]))
        dispatches = []
        for rdev, rval, rpos in rounds:
            bucket = self._bucket_for(rdev.shape[0])
            with self.tracer.span("scoring.update_and_score",
                                  n_events=rdev.shape[0]):
                scores_dev = self.ring.update_and_score(
                    self.model, self.params, rdev, rval, bucket)
            # start the device→host copy NOW (non-blocking): the settle
            # thread then waits on this copy's event only
            self.batch_size_hist.observe(float(rdev.shape[0]))
            self.dispatches.inc()
            dispatches.append((start_to_host(scores_dev), rdev.shape[0], rpos))
        return dispatches

    async def _settle_and_deliver(self, dispatches, dev, ts,
                                  ingest, ctx, t0: float,
                                  fut: Optional[asyncio.Future] = None,
                                  seq: Optional[int] = None,
                                  traces: Optional[list] = None):
        # inflight covers settle AND sink delivery: drain() must not
        # consider a flush done until its scored output has been published
        loop = asyncio.get_running_loop()
        try:
            try:
                settled = await asyncio.gather(*[
                    loop.run_in_executor(SETTLE_POOL, result_to_host, s)
                    for s, _, _ in dispatches])
            except BaseException as exc:
                if fut is not None and not fut.done():
                    fut.set_exception(exc if isinstance(exc, Exception)
                                      else RuntimeError("settle cancelled"))
                # these events' scores are lost; account them explicitly
                self.dropped.inc(dev.shape[0])
                if isinstance(exc, Exception):
                    logger.exception("scoring settle failed")
                    return
                raise
            with self.tracer.span("scoring.settle",
                                  n_events=int(dev.shape[0])):
                now = time.monotonic()
                self.stage_device.observe(now - t0)
                self.scored_meter.mark(dev.shape[0])
                self.latency.observe_array(now - ingest)
                self.batch_latency.observe(now - t0)
                if settled and isinstance(settled[0], tuple):
                    # sparse anomaly readback: the anomalous subset
                    # only; every event was still scored on the device
                    # (`total_scored`)
                    fpos, a_scores = sparse_rows(
                        ((s, n, rpos) for s, (_, n, rpos)
                         in zip(settled, dispatches)),
                        self.anomaly_overflow)
                    self.anomalies.inc(int(fpos.shape[0]))
                    scored = ScoredBatch(ctx, dev[fpos], a_scores,
                                         np.ones(fpos.shape[0], bool),
                                         ts[fpos],
                                         model_version=self.version,
                                         total_scored=int(dev.shape[0]))
                else:
                    scores = np.empty(dev.shape[0], np.float32)
                    for scores_u, (_, n, rpos) in zip(settled,
                                                      dispatches):
                        if rpos is None:
                            scores[:n] = scores_u[:n]
                        else:
                            scores[rpos] = scores_u[:n]
                    is_anom = scores >= self.cfg.threshold
                    n_anom = int(is_anom.sum())
                    if n_anom:
                        self.anomalies.inc(n_anom)
                    scored = ScoredBatch(ctx, dev, scores, is_anom, ts,
                                         model_version=self.version)
                for trace_id, n_ev, *_ in (traces or [(ctx.trace_id,
                                                       dev.shape[0])]):
                    self.tracer.record(trace_id, "rule-processing.score",
                                       ctx.tenant_id, t0, now - t0, n_ev)
            # the delivery stays out of the settle's span, as the pool's
            # does: it awaits, and the loop runs other work meanwhile
            if fut is not None and not fut.done():
                fut.set_result(scored)
            if self.sink is not None:
                await deliver_scored(self.sink, scored,
                                     self.sink_failures, self.stage_sink)
        finally:
            self.inflight -= 1
            self.settled_count += 1
            if seq is not None:
                self._outstanding.discard(seq)

    def _dispatch_chunks(self, dev, val, ts, ingest, ctx, t0,
                         futs: Optional[list] = None,
                         traces: Optional[list] = None) -> tuple:
        """Chunk a flush to the max bucket, dispatch each chunk, and
        schedule its settle. Sequential dispatch preserves per-device
        arrival order across chunks. Returns (chunks dispatched, failed)."""
        loop = asyncio.get_running_loop()
        max_b = self.cfg.buckets[-1]
        # queue wait (admission → dispatch) per admitted batch; the
        # settle records "rule-processing.score" for the device half
        for trace_id, n_ev, t_admit in traces or ():
            self.tracer.record(trace_id, "rule-processing.dispatch",
                               ctx.tenant_id, t_admit,
                               max(t0 - t_admit, 0.0), n_ev)
        n_chunks = 0
        for lo in range(0, dev.shape[0], max_b):
            hi = lo + max_b
            try:
                with self.tracer.span("scoring.dispatch",
                                      n_events=min(hi, dev.shape[0]) - lo):
                    dispatches = self._dispatch(dev[lo:hi], val[lo:hi])
            except Exception:
                logger.exception("scoring dispatch failed; reloading ring")
                self.dropped.inc(dev.shape[0] - lo)
                self._recover_ring()
                break
            self.inflight += 1
            seq = self.dispatch_count
            self.dispatch_count += 1
            self._outstanding.add(seq)
            fut = loop.create_future() if futs is not None else None
            if fut is not None:
                futs.append(fut)
            task = loop.create_task(self._settle_and_deliver(
                dispatches, dev[lo:hi], ts[lo:hi],
                ingest[lo:hi], ctx, t0, fut, seq,
                traces if lo == 0 else None))
            self._settle_tasks.add(task)
            task.add_done_callback(self._settle_task_done)
            n_chunks += 1
        else:
            return n_chunks, False
        return n_chunks, True  # broke out: a chunk's dispatch failed

    def _settle_task_done(self, task) -> None:
        self._settle_tasks.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.error("settle task died unexpectedly",
                         exc_info=task.exception())

    def _start_regrow(self) -> None:
        """A pending event's device index outgrew the ring: grow and
        re-warm OFF the hot path (ready=False holds flushes)."""
        if self._regrow_task is not None and not self._regrow_task.done():
            return
        self.ready = False

        async def regrow():
            async def attempt():
                while self._pending_max >= self.ring.capacity:
                    self.ring.ensure_capacity(self._pending_max)
                    for out in self._warm_dispatches():
                        while not result_ready(out):
                            await asyncio.sleep(0.01)

            await retry_backoff(attempt, self._recover_ring, logger,
                                "ring regrow")
            self.ready = True

        self._regrow_task = asyncio.get_running_loop().create_task(
            regrow(), name="scoring-regrow")

    def flush_nowait(self) -> bool:
        """Dispatch the pending admissions; results are delivered to
        `self.sink` when they settle. Returns False if nothing flushed."""
        if self._pending_n == 0 or self.inflight >= self.cfg.max_inflight:
            return False
        if self.faults is not None:
            self.faults.check("scoring.dispatch")
        if self._pending_max >= self.ring.capacity:
            self._start_regrow()  # grow off the hot path
            return False
        with self.tracer.span("scoring.take_pending"):
            dev, val, ts, ingest, ctx, traces = self._take_pending()
        return self._dispatch_chunks(dev, val, ts, ingest, ctx,
                                     time.monotonic(),
                                     traces=traces)[0] > 0

    async def flush(self) -> Optional[ScoredBatch]:
        """Dispatch pending admissions and await the settled batch
        (tests / callers that want the result inline; a pipeline uses
        `flush_nowait` + `sink`). Raises if any chunk's dispatch failed
        (no silent partial results)."""
        if self._pending_n == 0:
            return None
        if self.faults is not None:
            await self.faults.acheck("scoring.dispatch")
        with self.tracer.span("scoring.take_pending"):
            dev, val, ts, ingest, ctx, traces = self._take_pending()
        futs: list[asyncio.Future] = []
        _, failed = self._dispatch_chunks(dev, val, ts, ingest, ctx,
                                          time.monotonic(), futs,
                                          traces=traces)
        if failed:
            raise RuntimeError("scoring dispatch failed (ring reloaded); "
                               f"{len(futs)} of the flush's chunks survived")
        batches = [await f for f in futs]
        if len(batches) == 1:
            return batches[0]
        sparse = any(b.total_scored >= 0 for b in batches)
        return ScoredBatch(
            ctx, np.concatenate([b.device_index for b in batches]),
            np.concatenate([b.score for b in batches]),
            np.concatenate([b.is_anomaly for b in batches]),
            np.concatenate([b.ts for b in batches]),
            model_version=self.version,
            # sparse chunks: the merged batch's scored count is the sum of
            # the chunks' counts, not len(self) (-1 means full readback)
            total_scored=(sum(max(b.total_scored, len(b))
                              for b in batches) if sparse else -1))

    def _recover_ring(self) -> None:
        # a dispatch that failed mid-update leaves the ring inconsistent —
        # allocate fresh state FIRST, then repopulate it from the host store
        self.ring = self._new_ring(self.ring.capacity)
        try:
            self._load_ring()
        except Exception:  # noqa: BLE001 - empty ring still scores (count=0)
            logger.exception("ring reload from host store failed")

    async def drain(self, timeout: float = 30.0) -> None:
        """Wait for every dispatched flush to settle (shutdown path)."""
        deadline = time.monotonic() + timeout
        while self.inflight > 0 and time.monotonic() < deadline:
            await asyncio.sleep(0.01)

    def close(self) -> None:
        """Release the ring's device memory (the session's end of life)."""
        self.ring.close()
