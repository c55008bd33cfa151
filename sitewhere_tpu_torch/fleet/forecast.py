"""Predictive control plane: the platform forecasts its own load (tenant-0).

The reactive autoscaler (controller.py, the ADApt replica-prediction
shape — PAPERS.md, arXiv 2504.03698) acts only AFTER backlog forms, and
every spawn it orders pays the ~13–19 s JAX startup + first-compile
reconvergence the fleet bench's kill drill measured. This module closes
the loop ROADMAP item 2 names: the durable telemetry history
(`persistence/durable.py TelemetryHistory` — per-tenant lag, egress
backlog, scoring occupancy, accept rate, per-worker loop lag) becomes
the training substrate for a lightweight forecaster, and its forecasts
become scale decisions placed ahead of the compile-time horizon.

Three pieces, one design rule — the platform is its own tenant:

- **FeaturePipeline** reads `TelemetryHistory` window rows into
  fixed-shape `[tenant, window, signal]` tensors on the store's own
  aggregation grid. Gaps are explicit: a window no worker wrote (a
  restart hole, a thin young tenant) is `valid=False`, never a
  fabricated zero — the PMU streaming/historical split
  (arXiv 2512.22231), where the historical tier answers with what was
  actually observed.
- **tenant-0 serving**: the forecaster (`models/seasonal.py`, trained
  by the ordinary `training/trainer.py` loop and checkpointed via
  `training/checkpoint.py`) deploys under the reserved internal tenant
  id (`config.RESERVED_TENANT`) through the SAME version-fenced
  model-update path (`TenantSlot.swap_params`) and scores through the
  SAME shared megabatch pool (`scoring/pool.py`) as customer models —
  forecast dispatch is fenced, observed, and traced exactly like
  production scoring, not a side loop with its own failure modes.
  Reservation (kernel/observe.per_tenant_lags, kernel/flow,
  kernel/service) keeps this internal traffic out of the customer lag
  matrix and the fair-admission roster.
- **PredictivePlanner** folds into `FleetController.autoscale()`:
  fresh per-tenant forecasts convert into an `add_replica` decision
  when the PREDICTED per-worker load crosses the same `scale_up_lag`
  bar the reactive path uses — so a spawn starts its compile warmup
  before the backlog exists. The reactive logic stays the fallback
  floor: a confidence/staleness gate (model cold, history thin,
  forecast stale, horizon error EMA high) demotes to pure-reactive,
  and every predictive decision carries its forecast provenance into
  the controller's audit trail.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from typing import Optional, Sequence

import numpy as np

from sitewhere_tpu_torch.config import RESERVED_TENANT
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.domain.batch import (
    BatchContext,
    MeasurementBatch,
    ScoredBatch,
)
from sitewhere_tpu_torch.models.registry import build_model
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from sitewhere_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

# the per-tenant load target is the sum of these history series — the
# same three signals the reactive worker_loads() sums live
LOAD_SIGNALS = ("lag", "egress_backlog", "scoring_pending")
# the full feature-tensor signal axis ([tenant, window, signal]);
# loop_lag_ms is worker-scoped in the history and broadcast per tenant
# as the fleet mean (a stalling fleet loop leads lag everywhere)
SIGNALS = LOAD_SIGNALS + ("accept_rate", "loop_lag_ms")


class FeaturePipeline:
    """TelemetryHistory → fixed-shape feature tensors on the store's
    aggregation grid.

    Every read resolves onto an explicit grid of window STARTS (the
    history's `window_s` spacing), so `since`/`until` boundary
    semantics, flush-split row merges, and the open live-tail window
    are all the store's problem (`TelemetryHistory.history` already
    merges and bounds); this layer only places merged rows at
    `round((row.window - grid0) / window_s)` and marks everything else
    invalid — restart gaps and pre-tenant history stay visible to the
    model as masked steps, not as zeros that would read as "load
    vanished"."""

    def __init__(self, history, signals: Sequence[str] = SIGNALS):
        self.history = history
        self.signals = tuple(signals)

    @property
    def window_s(self) -> float:
        return float(self.history.window_s)

    def grid(self, window: int, until: Optional[float] = None) -> np.ndarray:
        """The last `window` aggregation-window starts strictly below
        `until` (default now). `until` is exclusive on window START —
        the same contract as `history(until=)` — so `until=w0 + n*ws`
        ends the grid exactly at window `w0 + (n-1)*ws`."""
        ws = self.window_s
        t = time.time() if until is None else float(until)
        last = (math.ceil(t / ws) - 1) * ws
        return last - ws * np.arange(window - 1, -1, -1, dtype=np.float64)

    def series_grid(self, tenant: str, signal: str,
                    starts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One series resolved onto a grid: (values [W] f32, valid [W]).
        A window's value is its in-window MEAN (sum/count — beat samples
        arrive several per window; the mean is cadence-independent where
        `last` would alias the beat phase)."""
        ws = self.window_s
        w0 = float(starts[0])
        rows = self.history.history(tenant, signal, since=w0,
                                    until=float(starts[-1]) + ws)
        vals = np.zeros(starts.shape[0], np.float32)
        valid = np.zeros(starts.shape[0], bool)
        for row in rows:
            idx = int(round((row["window"] - w0) / ws))
            if 0 <= idx < starts.shape[0] and row.get("count", 0) > 0:
                vals[idx] = row["sum"] / row["count"]
                valid[idx] = True
        return vals, valid

    def _fleet_loop_lag(self, starts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Fleet-mean loop lag per window over every worker-scoped
        `loop_lag_ms` series; invalid where NO worker wrote the window
        (the whole fleet was down/restarting — a genuine gap)."""
        total = np.zeros(starts.shape[0], np.float32)
        n = np.zeros(starts.shape[0], np.float32)
        for key, sig in self.history.series():
            if sig != "loop_lag_ms":
                continue
            v, m = self.series_grid(key, "loop_lag_ms", starts)
            total += np.where(m, v, 0.0)
            n += m
        return (total / np.maximum(n, 1.0)).astype(np.float32), n > 0

    def features(self, tenants: Sequence[str], *, window: int,
                 until: Optional[float] = None
                 ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The tentpole tensor: ([T, W, S] f32, valid [T, W, S] bool,
        window starts [W] f64) over `self.signals`."""
        starts = self.grid(window, until)
        ll, llv = self._fleet_loop_lag(starts)
        x = np.zeros((len(tenants), window, len(self.signals)), np.float32)
        valid = np.zeros_like(x, dtype=bool)
        for ti, tid in enumerate(tenants):
            for si, sig in enumerate(self.signals):
                if sig == "loop_lag_ms":
                    x[ti, :, si], valid[ti, :, si] = ll, llv
                else:
                    x[ti, :, si], valid[ti, :, si] = \
                        self.series_grid(tid, sig, starts)
        return x, valid, starts

    def load_series(self, tenant: str, *, window: int,
                    until: Optional[float] = None
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The planner's scalar target: per-window lag + egress backlog
        + scoring pending (the reactive `worker_loads()` sum, on the
        history grid). A window is valid when ANY contributing series
        wrote it — a tenant idle on two signals still has a load — and
        invalid when none did (restart hole)."""
        starts = self.grid(window, until)
        vals = np.zeros(window, np.float32)
        valid = np.zeros(window, bool)
        for sig in LOAD_SIGNALS:
            v, m = self.series_grid(tenant, sig, starts)
            vals += np.where(m, v, 0.0)
            valid |= m
        return vals, valid, starts

    def training_windows(self, tenants: Sequence[str], window: int, *,
                         stride: int = 1, depth: int = 512,
                         until: Optional[float] = None,
                         min_valid: int = 4
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Sliding training windows over every tenant's load series,
        with GENUINE validity masks (`training/trainer.make_windows`
        cuts from the gapless ring store and marks everything valid;
        history-fed windows carry their restart holes into the loss
        mask instead). Windows with fewer than `min_valid` observed
        steps are dropped — all-gap lead-ins train nothing."""
        xs, vs = [], []
        for tid in tenants:
            vals, valid, _ = self.load_series(tid, window=depth, until=until)
            if not valid.any():
                continue
            first = int(np.argmax(valid))  # trim the pre-tenant lead-in
            vals, valid = vals[first:], valid[first:]
            for i in range(0, vals.shape[0] - window + 1, stride):
                v = valid[i:i + window]
                if int(v.sum()) >= min_valid:
                    xs.append(vals[i:i + window])
                    vs.append(v)
        if not xs:
            return (np.zeros((0, window), np.float32),
                    np.zeros((0, window), bool))
        return np.stack(xs).astype(np.float32), np.stack(vs)


class PredictivePlanner:
    """Forecast-driven half of the autoscaler (owned by FleetController).

    `tick()` (async, once per `fleet_forecast_interval_s` from the
    controller loop) admits each tenant's newly CLOSED history windows
    into the tenant-0 scoring slot — one point per aggregation window,
    so the pool's device ring accumulates the true load time-step
    series — and resolves matured forecasts against realized load into
    the horizon-error EMA. `decide()` (sync, from `autoscale()`) turns
    fresh forecasts into an audited `add_replica` ahead of the reactive
    path, behind the confidence gate."""

    def __init__(self, controller):
        self.controller = controller
        self.runtime = controller.runtime
        settings = self.runtime.settings
        self.history = self.runtime.history
        self.pipeline = FeaturePipeline(self.history)
        self.horizon_s = float(getattr(settings,
                                       "fleet_forecast_horizon_s", 15.0))
        self.window = int(getattr(settings, "fleet_forecast_window", 32))
        self.interval_s = float(getattr(settings,
                                        "fleet_forecast_interval_s", 1.0))
        self.min_windows = int(getattr(settings,
                                       "fleet_forecast_min_windows", 8))
        self.max_stale_s = float(getattr(settings,
                                         "fleet_forecast_max_stale_s", 30.0))
        self.error_gate = float(getattr(settings,
                                        "fleet_forecast_error_gate", 3.0))
        # the model's step IS the history aggregation window; the
        # horizon in steps covers `fleet_forecast_horizon_s` of wall
        # time (at least one step, and the window must keep a context
        # of at least the model's min_history valid steps — a shorter
        # context scores 0 forever, which reads as "forecast flat")
        ws = self.pipeline.window_s
        self.horizon_steps = int(min(max(round(self.horizon_s / ws), 1),
                                     max(self.window - 4, 1)))
        # tenant-0 serves on `InstanceSettings.device` (the card unless
        # the CPU is named), as rule-processing does
        self.device = resolve_device(settings.device)
        self.model = build_model("seasonal", device=self.device,
                                 window=self.window,
                                 horizon=self.horizon_steps)
        metrics = self.runtime.metrics
        self.decisions_c = metrics.counter("fleet.forecast_decisions")
        self.demotions_c = metrics.counter("fleet.forecast_demotions")
        self.trainings_c = metrics.counter("fleet.forecast_trainings")
        self.err_gauge = metrics.gauge("fleet.forecast_horizon_error_ema")
        self.version_gauge = metrics.gauge("fleet.forecast_model_version")
        self.pred_gauge = metrics.gauge("fleet.forecast_load_predicted")
        # tenant-0's "devices" are the monitored tenants: one telemetry
        # slot per customer tenant, assigned on first admit
        self.store = TelemetryStore(history=max(4 * self.window, 256),
                                    initial_devices=64)
        self.pool: Optional[SharedScoringPool] = None
        self.slot = None
        self._devmap: dict[str, int] = {}
        self._devlist: list[str] = []
        self._last_admit: dict[str, float] = {}
        self.forecasts: dict[str, dict] = {}
        self._checks: list[tuple[float, str, float]] = []
        self.error_ema: Optional[float] = None
        self.model_version = 0
        self.train_report: Optional[dict] = None
        self._trained = False
        self._pending_params: Optional[dict] = None
        self._demoted = False
        self._gate_reason: Optional[str] = "serving path not started"
        self._last_tick = -1e9
        # controller-loop retrain cadence:
        # > 0 refreshes tenant-0 from the history tier on schedule. The
        # first window is measured from planner construction, not from
        # an immediate train — boot-time history is exactly what
        # train_from_history would reject as thin
        self.retrain_s = float(getattr(settings,
                                       "fleet_forecast_retrain_s", 0.0))
        self._last_retrain = time.monotonic()
        self._retraining = False
        self.scheduled_retrains = 0

    # -- tenant-0 serving ----------------------------------------------------

    def _checkpoint_store(self):
        data_dir = getattr(self.runtime.settings, "data_dir", None)
        if not data_dir:
            return None
        import os

        from sitewhere_tpu_torch.training.checkpoint import CheckpointStore

        return CheckpointStore(os.path.join(data_dir, "checkpoints"))

    async def _ensure_serving(self) -> None:
        """Deploy the forecaster as tenant-0 on first tick: backfill the
        slot store from history, then register through the shared pool —
        the production scoring path (warmup gate, megabatch flusher,
        version fence, settle tracing) with zero forecast-only code."""
        if self.pool is not None:
            return
        params = self._pending_params
        self._pending_params = None
        if params is None:
            store = self._checkpoint_store()
            if store is not None:
                try:
                    params, meta = store.load(RESERVED_TENANT,
                                              self.model.name)
                    params = params_from_numpy(params, self.device)
                    self.model_version = int(meta.get("version", 1))
                    self._trained = True
                    logger.info("fleet forecast: restored checkpoint v%d",
                                self.model_version)
                except FileNotFoundError:
                    params = None
                except Exception:  # noqa: BLE001 - cold start still serves
                    logger.warning("fleet forecast: checkpoint restore "
                                   "failed; starting cold", exc_info=True)
                    params = None
        cfg = PoolConfig(batch_buckets=(64,), batch_window_ms=25.0,
                         max_inflight=4, window_auto=False)
        self.pool = SharedScoringPool(self.model, self.runtime.metrics,
                                      cfg, tracer=self.runtime.tracer,
                                      faults=self.runtime.faults,
                                      device=self.device)
        for tid in sorted(self.controller.tenants):
            self._backfill(tid)
        self.slot = self.pool.register(
            RESERVED_TENANT, self.store,
            threshold=float(self.controller.policy.scale_up_lag),
            deliver=self._on_scored, params=params, internal=True)
        if self.model_version:
            self.version_gauge.set(self.model_version)

    def _dev(self, tid: str) -> int:
        slot = self._devmap.get(tid)
        if slot is None:
            slot = self._devmap[tid] = len(self._devlist)
            self._devlist.append(tid)
        return slot

    def _backfill(self, tid: str) -> None:
        """Seed a tenant's slot store from history before registration
        (the pool's ring seeds from the store at register time); sets
        the admit cursor so `tick()` continues where backfill ended."""
        ws = self.pipeline.window_s
        open_start = math.floor(time.time() / ws) * ws
        vals, valid, starts = self.pipeline.load_series(
            tid, window=self.window, until=open_start)
        self._last_admit[tid] = open_start - ws
        if not valid.any():
            return
        dev = self._dev(tid)
        n = int(valid.sum())
        self.store.append_values(np.full(n, dev, np.int64), vals[valid],
                                 starts[valid])

    async def _on_scored(self, scored: ScoredBatch) -> None:
        """The pool's deliver callback for tenant-0: a ScoredBatch's
        scores ARE the per-tenant horizon load forecasts (seasonal
        model contract), stamped with the version fence's snapshot.
        Points arrive in admit order, so the newest wins per tenant."""
        now = time.monotonic()
        for i in range(len(scored)):
            dev = int(scored.device_index[i])
            if dev >= len(self._devlist):
                continue  # devmap raced a recovery reseed; skip
            tid = self._devlist[dev]
            load = float(scored.score[i])
            if not math.isfinite(load):
                continue  # a diverged model must not poison the EMA
            self.forecasts[tid] = {
                "load": load,
                "made_t": float(scored.ts[i]),
                "made_monotonic": now,
                "model_version": int(scored.model_version),
            }
            # horizon-error accounting: judge this forecast against the
            # load realized `horizon_s` from NOW (bounded backlog).
            # Untrained (structural-only cold start) forecasts are
            # served but not judged — the "model cold" gate already
            # blocks them from driving decisions, and charging them to
            # the EMA would demote the planner before its first train.
            if self._trained:
                self._checks.append((time.time() + self.horizon_s,
                                     tid, load))
        del self._checks[:-256]

    # -- the planner loop (controller tick) ----------------------------------

    async def tick(self) -> None:
        if not getattr(self.runtime.settings, "fleet_forecast", True):
            return
        now = time.monotonic()
        if now - self._last_tick < self.interval_s:
            return
        self._last_tick = now
        await self._ensure_serving()
        ws = self.pipeline.window_s
        open_start = math.floor(time.time() / ws) * ws
        for tid in sorted(self.controller.tenants):
            self._admit_closed_windows(tid, open_start)
        self._resolve_checks(time.time())
        await self._maybe_retrain(now)

    async def _maybe_retrain(self, now: float) -> None:
        """Scheduled retrain (`fleet_forecast_retrain_s` > 0): refresh
        the tenant-0 forecaster from the history tier on cadence
        instead of on demand. The train runs in an executor thread —
        Trainer.train is seconds of blocking JAX work and the
        controller loop must keep ticking through it — and the
        `_retraining` latch keeps the cadence to one train in flight
        (a slow train never stacks a second). Each completed retrain
        is transition-counted (`scheduled_retrains`, one per event,
        not per tick) and audit-logged into the autoscaler decision
        trail beside scale actions."""
        if self.retrain_s <= 0 or self._retraining:
            return
        if now - self._last_retrain < self.retrain_s:
            return
        self._retraining = True
        try:
            report = await asyncio.get_running_loop().run_in_executor(
                None, self.train_from_history)
        except Exception:  # noqa: BLE001 - cadence must survive one bad pass
            logger.exception("fleet forecast: scheduled retrain failed; "
                             "next window retries")
            report = None
        finally:
            self._last_retrain = time.monotonic()
            self._retraining = False
        if report is None:
            return  # history too thin (already logged) or train failed
        self.scheduled_retrains += 1
        self.controller.decisions.append({
            "t": time.time(), "action": "retrain", "actuated": True,
            "reason": f"scheduled (every {self.retrain_s:g}s)",
            "version": report.get("version"),
            "windows": report.get("windows"),
            "final_loss": report.get("final_loss")})
        del self.controller.decisions[:-32]
        logger.info("fleet forecast: scheduled retrain #%d -> v%s "
                    "(%s windows)", self.scheduled_retrains,
                    report.get("version"), report.get("windows"))

    def _admit_closed_windows(self, tid: str, open_start: float) -> None:
        """Admit one point per newly CLOSED aggregation window through
        the pool (the open window still accumulates — admitting it
        would score a half-window as a load drop). Gap windows are
        skipped, not zero-filled: the ring holds observed values only,
        and the thin-history gate covers cold stretches."""
        ws = self.pipeline.window_s
        last = self._last_admit.get(tid)
        if last is None:
            self._backfill(tid)
            if self.slot is not None:
                self.slot.reload_history()
            return
        n_new = int(round((open_start - ws - last) / ws))
        if n_new <= 0:
            return
        n_new = min(n_new, self.window)
        vals, valid, starts = self.pipeline.load_series(
            tid, window=n_new, until=open_start)
        self._last_admit[tid] = open_start - ws
        if not valid.any() or self.pool is None:
            return
        dev = self._dev(tid)
        n = int(valid.sum())
        dev_col = np.full(n, dev, np.uint32)
        v = vals[valid].astype(np.float32)
        ts = starts[valid].astype(np.float64)
        self.store.append_values(dev_col.astype(np.int64), v, ts)
        self.pool.admit(RESERVED_TENANT, MeasurementBatch(
            BatchContext(tenant_id=RESERVED_TENANT,
                         source="fleet.forecast"),
            dev_col, np.zeros(n, np.uint16), v, ts))

    def _resolve_checks(self, wall: float) -> None:
        """Fold matured forecasts into the horizon-error EMA (the
        confidence gate's accuracy signal, and the
        `fleet.forecast_horizon_error_ema` gauge). The error is
        OVERPREDICTION measured in scale-up-bar units: the gate exists
        to stop phantom scale-ups, so "predicted a bar-crossing load
        that never materialized" is the failure it tracks — an EMA of
        1.0 means forecasts routinely overshoot reality by a whole
        decision bar. Underprediction is not charged: the reactive
        floor runs every tick regardless, so a ramp steeper than
        forecast costs nothing predictive-specific (and charging it
        would demote the planner exactly when load regimes shift —
        the moment the reactive floor is already covering)."""
        due = [c for c in self._checks if c[0] <= wall]
        if not due:
            return
        self._checks = [c for c in self._checks if c[0] > wall]
        bar = max(float(self.controller.policy.scale_up_lag), 1.0)
        for _t, tid, predicted in due:
            vals, valid, _ = self.pipeline.load_series(tid, window=4)
            if not valid.any():
                continue
            realized = float(vals[valid][-1])
            err = max(predicted - realized, 0.0) / bar
            self.error_ema = (err if self.error_ema is None
                              else 0.7 * self.error_ema + 0.3 * err)
        if self.error_ema is not None:
            self.err_gauge.set(round(self.error_ema, 4))

    # -- training ------------------------------------------------------------

    def train_from_history(self, *, steps: Optional[int] = None,
                           until: Optional[float] = None
                           ) -> Optional[dict]:
        """Train (or refresh) the forecaster from history readback via
        the ordinary trainer, checkpoint it, and hot-swap it into the
        tenant-0 slot through the version-fenced update path. Returns
        the train report, or None when history is too thin to train."""
        from sitewhere_tpu_torch.training.trainer import Trainer, TrainerConfig

        tenants = sorted(
            (set(self.controller.tenants)
             | {t for t, s in self.history.series() if s in LOAD_SIGNALS})
            - {RESERVED_TENANT})
        windows, valid = self.pipeline.training_windows(
            tenants, self.window, until=until)
        if windows.shape[0] < 4:
            logger.info("fleet forecast: history too thin to train "
                        "(%d windows)", windows.shape[0])
            return None
        cfg = TrainerConfig(steps=int(steps or 120),
                            batch_size=min(256, max(8 * windows.shape[0], 8)),
                            log_every=50)
        params, report = Trainer(self.model, cfg).train(windows, valid)
        meta = {"windows": int(windows.shape[0]),
                "tenants": len(tenants),
                "horizon_steps": self.horizon_steps,
                "window_s": self.pipeline.window_s,
                "final_loss": report.get("final_loss")}
        store = self._checkpoint_store()
        version = (store.save(RESERVED_TENANT, self.model.name, params,
                              metadata=meta)
                   if store is not None else self.model_version + 1)
        if self.slot is not None:
            self.slot.swap_params(params)
        else:
            self._pending_params = params  # deployed at _ensure_serving
        self.model_version = int(version)
        self._trained = True
        # a fresh model is judged on its own record: pending checks and
        # the error EMA belong to the version just replaced (this is why
        # the runbook's "retrain to re-arm sooner" works)
        self._checks.clear()
        self.error_ema = None
        self.trainings_c.inc()
        self.version_gauge.set(self.model_version)
        report = dict(report, version=self.model_version, **meta)
        self.train_report = report
        logger.info("fleet forecast: trained v%d over %d windows "
                    "(final loss %s)", self.model_version,
                    windows.shape[0], report.get("final_loss"))
        return report

    # -- the decision (autoscale integration) --------------------------------

    def _history_depth(self) -> int:
        """Closed-window depth of the busiest tenant series (bounded
        read: `limit` caps the slice)."""
        depth = 0
        for tid in self.controller.tenants:
            depth = max(depth, len(self.history.history(
                tid, "lag", limit=self.min_windows)))
        return depth

    def gate(self) -> Optional[str]:
        """Why forecasts must NOT drive scaling right now (None = clear).
        Ordered from structural to transient; the first reason wins."""
        if self.pool is None or self.slot is None:
            return "serving path not started"
        if not self._trained:
            return "model cold (no trained version deployed)"
        depth = self._history_depth()
        if depth < self.min_windows:
            return f"history thin ({depth} < {self.min_windows} windows)"
        now = time.monotonic()
        ages = [now - f["made_monotonic"]
                for tid, f in self.forecasts.items()
                if tid in self.controller.tenants]
        if not ages or min(ages) > self.max_stale_s:
            return "no fresh forecast"
        if self.error_ema is not None and self.error_ema > self.error_gate:
            return (f"horizon error EMA {self.error_ema:.2f} > "
                    f"{self.error_gate:.2f}")
        return None

    def decide(self, loads: dict[str, float],
               lags: dict[str, int]) -> Optional[dict]:
        """The predictive half of `autoscale()`: an `add_replica` with
        forecast provenance when predicted per-worker load crosses the
        reactive scale-up bar, else None (fall through to reactive).
        Pure read of planner state — safe to call from sync code."""
        del lags  # forecasts already integrate the per-tenant series
        if not getattr(self.runtime.settings, "fleet_forecast", True):
            return None
        reason = self.gate()
        self._gate_reason = reason
        if reason is not None:
            if not self._demoted:
                # transition-counted: the gauge-watcher wants "how often
                # did we fall back", not one count per gated tick
                self._demoted = True
                self.demotions_c.inc()
                logger.info("fleet forecast: demoted to reactive (%s)",
                            reason)
            return None
        if self._demoted:
            self._demoted = False
            logger.info("fleet forecast: gate clear; predictive resumed")
        c = self.controller
        policy = c.policy
        now = time.monotonic()
        live_n = len(loads)
        if not live_n or now - c._last_scale_t < policy.cooldown_s:
            return None
        fresh = {tid: f for tid, f in self.forecasts.items()
                 if tid in c.tenants
                 and now - f["made_monotonic"] <= self.max_stale_s}
        predicted = sum(f["load"] for f in fresh.values())
        self.pred_gauge.set(round(predicted, 1))
        per_worker = predicted / live_n
        if per_worker > policy.scale_up_lag \
                and live_n + c._pending_spawns < policy.max_workers:
            self.decisions_c.inc()
            return {
                "action": "add_replica",
                "reason": (f"forecast: predicted load/worker "
                           f"{per_worker:.0f} > {policy.scale_up_lag:.0f} "
                           f"within {self.horizon_s:.0f}s"),
                "forecast": {
                    "horizon_s": self.horizon_s,
                    "predicted_load": round(predicted, 1),
                    "per_worker": round(per_worker, 1),
                    "model_version": max((f["model_version"]
                                          for f in fresh.values()),
                                         default=self.model_version),
                    "error_ema": (round(self.error_ema, 4)
                                  if self.error_ema is not None else None),
                    "tenants": {tid: round(f["load"], 1)
                                for tid, f in sorted(fresh.items())},
                },
            }
        return None

    # -- status (REST `GET /api/fleet/forecast`, `swx top --fleet`) ----------

    def snapshot(self) -> dict:
        now = time.monotonic()
        return {
            "enabled": bool(getattr(self.runtime.settings,
                                    "fleet_forecast", True)),
            "serving": self.pool is not None,
            "trained": self._trained,
            "gate": self._gate_reason or "ok",
            "demoted": self._demoted,
            "horizon_s": self.horizon_s,
            "horizon_steps": self.horizon_steps,
            "window": self.window,
            "window_s": self.pipeline.window_s,
            "model_version": self.model_version,
            "error_ema": (round(self.error_ema, 4)
                          if self.error_ema is not None else None),
            "decisions": int(self.decisions_c.value),
            "demotions": int(self.demotions_c.value),
            "trainings": int(self.trainings_c.value),
            "retrain_s": self.retrain_s,
            "scheduled_retrains": self.scheduled_retrains,
            "last_retrain_age_s": round(now - self._last_retrain, 1),
            "forecasts": {
                tid: {"load": round(f["load"], 1),
                      "age_s": round(now - f["made_monotonic"], 1),
                      "model_version": f["model_version"]}
                for tid, f in sorted(self.forecasts.items())
                if tid in self.controller.tenants},
            "train": self.train_report,
        }

    def close(self) -> None:
        if self.pool is not None:
            self.pool.close()
            self.pool = None
            self.slot = None
