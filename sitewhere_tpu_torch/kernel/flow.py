"""Per-tenant flow control: quotas, weighted-fair admission, overload shedding.

The north star serves "heavy traffic from millions of users" (ROADMAP), and
before this module the only backpressure between a socket and the card was
the scorer's global admission backlog — one misbehaving tenant or device
fleet could saturate ingress and starve every other tenant's pipeline. The
low-latency prediction-serving literature (PAPERS: Cloudflow; PMU stream
processing) makes load-aware admission the lever that protects p99 under
overload; this module is that lever as a first-class subsystem:

- `TokenBucket`: monotonic-clock per-tenant rate limiter (events/sec +
  burst). O(1) hot path, no locks (the platform is single-event-loop; the
  arithmetic is two float ops) — same discipline as kernel/metrics.py.
- `DrrScheduler`: deficit-round-robin weighted-fair queue. The inbound
  admission path drains through it instead of handling records FIFO, so
  under contention drained shares match configured weights.
- `OverloadController`: per-tenant shed-policy state machine driven by the
  scorer's backlog/inflight signals and the DLQ rate. Escalates
  ok → reject (shed at ingress) → degrade (score via the cheap host-side
  zscore fallback) → defer (spool to the deferred-events topic), with
  hysteresis so the mode doesn't flap at a threshold.
- `FlowController`: the instance-wide facade (`runtime.flow`). Quotas come
  from `InstanceSettings.flow_default_*` overlaid by each tenant's
  `flow:` config section, are settable at runtime
  (`GET/PUT /api/tenants/{id}/quota`, `swx quota show|set`), emit
  `flow.*` counters/gauges, and register the `flow.admit` / `flow.shed`
  fault-injection sites so chaos runs exercise shedding.

Every ingress edge charges `admit_ingress` (protocol listeners answer
over-quota publishes with protocol-appropriate errors, the Kafka endpoint
returns throttle-time, REST returns 429 + Retry-After), inbound processing
admits through `admit_fair`, and rule-processing consults `shed_mode`
before admitting to the scorer. See docs/FLOWCONTROL.md for the policy
runbook.
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

logger = logging.getLogger(__name__)

Clock = Callable[[], float]

SHED_MODES = ("ok", "reject", "degrade", "defer")
_MODE_RANK = {m: i for i, m in enumerate(SHED_MODES)}


class TokenBucket:
    """Monotonic-clock token bucket: `rate` tokens/sec, capacity `burst`.

    The hot path (`try_acquire`) is a subtraction and a comparison; refill
    is folded into the acquire so there is no timer task. `clock` is
    injectable for deterministic tests (fake clock)."""

    __slots__ = ("rate", "burst", "_tokens", "_t_last", "_clock")

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Clock = time.monotonic):
        if rate <= 0:
            raise ValueError(f"token bucket rate must be > 0, got {rate}")
        self.rate = float(rate)
        self.burst = float(burst) if burst else max(2.0 * rate, 64.0)
        self._tokens = self.burst
        self._clock = clock
        self._t_last = clock()

    def _refill(self, now: float) -> None:
        elapsed = now - self._t_last
        if elapsed > 0:
            self._tokens = min(self.burst, self._tokens + elapsed * self.rate)
            self._t_last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill(self._clock())
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0.0 = now)."""
        self._refill(self._clock())
        deficit = n - self._tokens
        return max(deficit / self.rate, 0.0)

    @property
    def tokens(self) -> float:
        self._refill(self._clock())
        return self._tokens


class _Lane:
    __slots__ = ("items", "deficit", "weight", "needs_topup")

    def __init__(self, weight: float = 1.0):
        self.items: deque = deque()       # (cost, payload)
        self.deficit = 0.0
        self.weight = weight
        self.needs_topup = True


class DrrScheduler:
    """Deficit round robin across named lanes (Shreedhar & Varghese).

    `enqueue(lane, payload, cost)` then `take()` drains in weighted-fair
    order: each lane visit tops its deficit up by `quantum × weight` and
    serves entries while the head's cost fits. O(1) per operation; with
    unit costs and quantum 1, drained shares converge to the weight
    ratio regardless of offered-load skew."""

    def __init__(self, quantum: float = 1.0):
        self.quantum = quantum
        self._lanes: dict[str, _Lane] = {}
        self._ring: deque[str] = deque()   # lanes with queued entries

    def lane_weight(self, lane: str, weight: float) -> None:
        self._lanes.setdefault(lane, _Lane()).weight = max(weight, 1e-6)

    def enqueue(self, lane: str, payload, cost: float = 1.0) -> None:
        ln = self._lanes.setdefault(lane, _Lane())
        if not ln.items:
            ln.needs_topup = True
            self._ring.append(lane)
        ln.items.append((max(cost, 1e-9), payload))

    @property
    def pending(self) -> int:
        return sum(len(ln.items) for ln in self._lanes.values())

    def take(self) -> Optional[tuple[str, object, float]]:
        """Next (lane, payload, cost) in DRR order, or None when empty."""
        while self._ring:
            name = self._ring[0]
            lane = self._lanes[name]
            if not lane.items:
                self._ring.popleft()
                lane.deficit = 0.0
                continue
            if lane.needs_topup:
                lane.deficit += self.quantum * lane.weight
                lane.needs_topup = False
            cost = lane.items[0][0]
            if cost <= lane.deficit:
                cost, payload = lane.items.popleft()
                lane.deficit -= cost
                if not lane.items:
                    self._ring.popleft()
                    lane.deficit = 0.0
                return name, payload, cost
            # deficit exhausted: rotate; the lane tops up on its next turn
            lane.needs_topup = True
            self._ring.rotate(-1)
        return None

    def drain(self, max_entries: Optional[int] = None) -> list:
        out = []
        while max_entries is None or len(out) < max_entries:
            entry = self.take()
            if entry is None:
                break
            out.append(entry)
        return out


class OverloadController:
    """Shed-policy state machine for one tenant.

    `update(pressure)` with pressure in [0, 1+] (scorer backlog fraction,
    optionally folded with the DLQ rate) moves the mode:

        ok ──≥reject_at──► reject ──≥degrade_at──► degrade ──≥defer_at──► defer

    Escalation is immediate; de-escalation requires pressure to fall below
    `hysteresis ×` the current mode's entry threshold, so a backlog
    hovering at a threshold cannot flap the policy every poll round."""

    def __init__(self, reject_at: float = 0.5, degrade_at: float = 0.75,
                 defer_at: float = 0.9, hysteresis: float = 0.8):
        self.reject_at = reject_at
        self.degrade_at = degrade_at
        self.defer_at = defer_at
        self.hysteresis = hysteresis
        self.mode = "ok"
        self.pressure = 0.0
        # operator/test override: while set, `current` ignores the
        # computed mode (cleared with force "auto")
        self.forced: Optional[str] = None

    @property
    def current(self) -> str:
        return self.forced if self.forced is not None else self.mode

    def _entry_threshold(self, mode: str) -> float:
        return {"ok": 0.0, "reject": self.reject_at,
                "degrade": self.degrade_at, "defer": self.defer_at}[mode]

    def _target(self, pressure: float) -> str:
        if pressure >= self.defer_at:
            return "defer"
        if pressure >= self.degrade_at:
            return "degrade"
        if pressure >= self.reject_at:
            return "reject"
        return "ok"

    def update(self, pressure: float) -> str:
        self.pressure = pressure
        target = self._target(pressure)
        if _MODE_RANK[target] >= _MODE_RANK[self.mode]:
            self.mode = target
        elif pressure < self._entry_threshold(self.mode) * self.hysteresis:
            self.mode = target
        return self.current

    def retry_after(self) -> float:
        """Backoff hint for rejected callers: scale with how far past the
        reject threshold the pressure sits (bounded; advisory only)."""
        over = max(self.pressure - self.reject_at, 0.0)
        return round(min(0.5 + 4.0 * over, 5.0), 3)


class DegradedZscore:
    """Cheap host-side fallback scorer for `degrade` mode: per-device
    EWMA mean/variance, one vectorized numpy pass per batch — no launch, no
    device round-trip. Scores approximate the zscore model's |x−μ|/σ.

    Intra-batch duplicate devices update last-write-wins (this is a shed
    path: the contract is bounded cost, not exact replay of the model)."""

    __slots__ = ("alpha", "eps", "_mean", "_var", "_seen")

    def __init__(self, alpha: float = 0.05, eps: float = 1e-3):
        self.alpha = alpha
        self.eps = eps
        self._mean = np.zeros(0, np.float32)
        self._var = np.zeros(0, np.float32)
        self._seen = np.zeros(0, bool)

    def _ensure(self, max_index: int) -> None:
        if max_index < self._mean.shape[0]:
            return
        n = max(1024, 2 * (max_index + 1))
        for name in ("_mean", "_var", "_seen"):
            old = getattr(self, name)
            grown = np.zeros(n, old.dtype)
            grown[:old.shape[0]] = old
            setattr(self, name, grown)

    def score(self, device_index: np.ndarray,
              values: np.ndarray) -> np.ndarray:
        if device_index.shape[0] == 0:
            return np.zeros(0, np.float32)
        dev = device_index.astype(np.int64, copy=False)
        x = values.astype(np.float32, copy=False)
        self._ensure(int(dev.max()))
        mean, var, seen = self._mean[dev], self._var[dev], self._seen[dev]
        z = np.where(seen, np.abs(x - mean) / np.sqrt(var + self.eps), 0.0)
        a = self.alpha
        new_mean = np.where(seen, (1 - a) * mean + a * x, x)
        new_var = np.where(seen, (1 - a) * var + a * (x - mean) ** 2, 1.0)
        self._mean[dev] = new_mean
        self._var[dev] = new_var
        self._seen[dev] = True
        return z.astype(np.float32, copy=False)


@dataclass(frozen=True)
class FlowDecision:
    admitted: bool
    retry_after: float = 0.0     # seconds; advisory hint for the caller
    reason: str = ""             # "quota" | "overload:<mode>" | ""


_ADMITTED = FlowDecision(True)


class _TenantFlow:
    __slots__ = ("bucket", "weight", "overload", "dlq_times",
                 "pressure_gauge", "level_gauge")

    def __init__(self, bucket: Optional[TokenBucket], weight: float,
                 overload: OverloadController, metrics=None,
                 tenant_id: str = ""):
        self.bucket = bucket
        self.weight = weight
        self.overload = overload
        self.dlq_times: deque[float] = deque(maxlen=256)
        # gauges resolved once: report_scorer runs every consumer poll
        # round — no name formatting/registry lookups on that path
        self.pressure_gauge = (metrics.gauge(f"flow.pressure:{tenant_id}")
                               if metrics is not None else None)
        self.level_gauge = (metrics.gauge(f"flow.shed_level:{tenant_id}")
                            if metrics is not None else None)


class FlowController:
    """Instance-wide per-tenant flow control (`runtime.flow`).

    Tenants without an explicit quota inherit the instance defaults
    (`InstanceSettings.flow_default_rate`; 0 = unlimited — admission is
    then shed-mode-gated only, zero added cost on the hot path)."""

    def __init__(self, settings=None, metrics=None,
                 clock: Clock = time.monotonic):
        self.settings = settings
        self.metrics = metrics
        self.clock = clock
        self.faults = None               # chaos seam (kernel/faults.py)
        self._tenants: dict[str, _TenantFlow] = {}
        # weighted-fair inbound admission: a shared instance-wide budget
        # drained through DRR lanes. 0/unset = uncapped (fast path).
        rate = getattr(settings, "flow_inbound_rate", 0.0) if settings else 0.0
        self._inbound_bucket = (
            TokenBucket(rate, clock=clock) if rate else None)
        self._fair = DrrScheduler(quantum=64.0)
        self._fair_pump_task: Optional[asyncio.Task] = None
        # waiters the pump has dequeued but not yet granted: the fast
        # path must also yield to these, or new arrivals would keep
        # stealing refilled tokens from the waiter at the head of the
        # DRR order (starvation inversion)
        self._fair_inflight = 0

    # -- quota configuration -------------------------------------------------

    def _defaults(self) -> tuple[float, float, float]:
        s = self.settings
        return (getattr(s, "flow_default_rate", 0.0) if s else 0.0,
                getattr(s, "flow_default_burst", 0.0) if s else 0.0,
                getattr(s, "flow_default_weight", 1.0) if s else 1.0)

    def _make_overload(self) -> OverloadController:
        s = self.settings
        return OverloadController(
            reject_at=getattr(s, "flow_reject_at", 0.5) if s else 0.5,
            degrade_at=getattr(s, "flow_degrade_at", 0.75) if s else 0.75,
            defer_at=getattr(s, "flow_defer_at", 0.9) if s else 0.9,
            hysteresis=getattr(s, "flow_hysteresis", 0.8) if s else 0.8)

    def configure_tenant(self, tenant) -> None:
        """(Re)configure a tenant's quota from its `flow:` config section
        overlaid on the instance defaults (TenantConfig.section)."""
        section = tenant.section("flow") if hasattr(tenant, "section") else {}
        d_rate, d_burst, d_weight = self._defaults()
        self.set_quota(tenant.tenant_id,
                       rate=section.get("rate", d_rate),
                       burst=section.get("burst", d_burst),
                       weight=section.get("weight", d_weight))

    def set_quota(self, tenant_id: str, rate: Optional[float] = None,
                  burst: Optional[float] = None,
                  weight: Optional[float] = None) -> None:
        """Runtime quota update (REST PUT /api/tenants/{id}/quota and
        `swx quota set`). rate 0/None = unlimited. Setting `rate`
        WITHOUT `burst` rescales the burst to the default for the new
        rate — carrying a stale burst across a rate change leaves the
        bucket unusable (burst 1 at 100k/s admits nothing)."""
        tf = self._tenants.get(tenant_id)
        cur_rate = tf.bucket.rate if tf is not None and tf.bucket else 0.0
        cur_burst = tf.bucket.burst if tf is not None and tf.bucket else 0.0
        cur_weight = tf.weight if tf is not None else self._defaults()[2]
        if burst is None:
            burst = cur_burst if rate is None else 0.0   # 0 → default
        else:
            burst = float(burst)
        rate = cur_rate if rate is None else float(rate)
        weight = cur_weight if weight is None else float(weight)
        bucket = TokenBucket(rate, burst or None,
                             clock=self.clock) if rate > 0 else None
        if bucket is not None and tf is not None and tf.bucket is not None:
            if (tf.bucket.rate == bucket.rate
                    and tf.bucket.burst == bucket.burst):
                bucket = tf.bucket   # unchanged params: keep the bucket
            else:
                # changed params: carry the token DEBT over — a fresh
                # full bucket would forgive a drained hog a whole burst
                # on every config touch
                bucket._tokens = min(tf.bucket.tokens, bucket.burst)
        overload = tf.overload if tf is not None else self._make_overload()
        new = _TenantFlow(bucket, weight, overload, self.metrics, tenant_id)
        if tf is not None:
            # overload state AND its DLQ-rate input survive a quota
            # change: zeroing dlq_times would de-escalate shedding in
            # the middle of a poison storm
            new.dlq_times = tf.dlq_times
        self._tenants[tenant_id] = new
        self._fair.lane_weight(tenant_id, weight)

    def drop_tenant(self, tenant_id: str) -> None:
        self._tenants.pop(tenant_id, None)

    def _tenant(self, tenant_id: str) -> _TenantFlow:
        tf = self._tenants.get(tenant_id)
        if tf is None:
            d_rate, d_burst, d_weight = self._defaults()
            bucket = TokenBucket(d_rate, d_burst or None,
                                 clock=self.clock) if d_rate > 0 else None
            tf = _TenantFlow(bucket, d_weight, self._make_overload(),
                             self.metrics, tenant_id)
            self._tenants[tenant_id] = tf
            self._fair.lane_weight(tenant_id, d_weight)
        return tf

    # -- ingress admission ---------------------------------------------------

    def count(self, name: str, tenant_id: str, n: float) -> None:
        if self.metrics is not None:
            self.metrics.counter(f"flow.{name}").inc(n)
            self.metrics.counter(f"flow.{name}:{tenant_id}").inc(n)

    def admit_ingress(self, tenant_id: str, n: float = 1.0) -> FlowDecision:
        """Charge `n` events against the tenant's quota at an ingress
        edge. Rejected publishes get a protocol-appropriate error from
        the calling listener; `retry_after` is the backoff hint."""
        if self.faults is not None:
            self.faults.check("flow.admit")
        tf = self._tenant(tenant_id)
        mode = tf.overload.current
        if mode != "ok":
            # overload shedding starts at ingress for every mode: the
            # deeper modes (degrade/defer) ADD drain mechanisms behind
            # this gate, they do not reopen it
            self.count("rejected", tenant_id, n)
            return FlowDecision(False, tf.overload.retry_after(),
                                f"overload:{mode}")
        if tf.bucket is not None and not tf.bucket.try_acquire(n):
            self.count("rejected", tenant_id, n)
            return FlowDecision(False, round(tf.bucket.retry_after(n), 3),
                                "quota")
        self.count("admitted", tenant_id, n)
        return _ADMITTED

    def charge_produced(self, tenant_id: str, n: float = 1.0) -> float:
        """Kafka-quota semantics: the records are DELIVERED either way,
        so they always count as admitted; over-quota usage is counted
        as `flow.throttled` (never `flow.rejected` — that counter means
        dropped traffic) and returns the throttle hint in seconds."""
        if self.faults is not None:
            self.faults.check("flow.admit")
        tf = self._tenant(tenant_id)
        self.count("admitted", tenant_id, n)
        mode = tf.overload.current
        if mode != "ok":
            self.count("throttled", tenant_id, n)
            return tf.overload.retry_after()
        if tf.bucket is not None and not tf.bucket.try_acquire(n):
            self.count("throttled", tenant_id, n)
            return max(round(tf.bucket.retry_after(n), 3), 0.001)
        return 0.0

    # -- weighted-fair inbound admission -------------------------------------

    async def admit_fair(self, tenant_id: str, cost: float = 1.0) -> None:
        """Admit `cost` events of inbound processing for `tenant_id`.

        Uncapped instances (flow_inbound_rate = 0, the default) return
        immediately. With a cap, callers queue in per-tenant DRR lanes
        and are granted in weighted-fair order as the shared budget
        refills — a hog tenant's backlog cannot starve its peers'
        inbound loops.

        The platform's reserved internal tenant (config.RESERVED_TENANT
        — the fleet forecaster's tenant-0) bypasses the roster: its
        scoring traffic is the control plane observing the fleet, and
        queuing it behind customer lanes would starve exactly the
        forecasts needed most when the fleet is saturated."""
        if self._inbound_bucket is None:
            return
        from sitewhere_tpu_torch.config import RESERVED_TENANT

        if tenant_id == RESERVED_TENANT:
            return
        if (self._fair.pending == 0 and self._fair_inflight == 0
                and self._inbound_bucket.try_acquire(cost)):
            return
        fut = asyncio.get_running_loop().create_future()
        self._fair.enqueue(tenant_id, fut, cost)
        if self._fair_pump_task is None or self._fair_pump_task.done():
            self._fair_pump_task = asyncio.get_running_loop().create_task(
                self._fair_pump(), name="flow-fair-pump")
        await fut

    async def _fair_pump(self) -> None:
        bucket = self._inbound_bucket
        while True:
            entry = self._fair.take()
            if entry is None:
                return
            tenant_id, fut, cost = entry
            if fut.done():      # waiter was cancelled; its grant is moot
                continue
            self._fair_inflight += 1
            try:
                while not bucket.try_acquire(cost):
                    await asyncio.sleep(
                        min(max(bucket.retry_after(cost), 0.001), 0.05))
                    if fut.done():
                        break
                if not fut.done():
                    fut.set_result(None)
                    self.count("fair_granted", tenant_id, cost)
            finally:
                self._fair_inflight -= 1

    # -- overload signals ----------------------------------------------------

    def report_scorer(self, tenant_id: str, pending: int, cap: int,
                      inflight: int = 0, max_inflight: int = 0) -> str:
        """Fold the scorer's backlog/inflight signals (and the tenant's
        recent DLQ rate) into the shed-policy state. Called from the
        rule-processing consumer loop each poll round; returns the mode."""
        tf = self._tenant(tenant_id)
        backlog_frac = pending / cap if cap > 0 else 0.0
        inflight_frac = (inflight / max_inflight) if max_inflight > 0 else 0.0
        # inflight saturation alone is healthy pipelining; it only
        # matters when a backlog is ALSO building, so weight it low
        pressure = max(backlog_frac, 0.5 * inflight_frac,
                       self._dlq_pressure(tf))
        mode = tf.overload.update(pressure)
        if tf.pressure_gauge is not None:
            tf.pressure_gauge.set(pressure)
            tf.level_gauge.set(_MODE_RANK[mode])
        return mode

    def _dlq_pressure(self, tf: _TenantFlow) -> float:
        if not tf.dlq_times:
            return 0.0
        now = self.clock()
        horizon = now - 10.0
        recent = sum(1 for t in tf.dlq_times if t >= horizon)
        rate_max = (getattr(self.settings, "flow_dlq_rate_max", 50.0)
                    if self.settings else 50.0)
        return min(recent / 10.0 / rate_max, 1.0)

    def note_dead_letter(self, tenant_id: str) -> None:
        self._tenant(tenant_id).dlq_times.append(self.clock())

    def shed_mode(self, tenant_id: str) -> str:
        """Current shed policy for the tenant ("ok" | "reject" |
        "degrade" | "defer"); consulted by rule-processing before each
        scorer admission."""
        if self.faults is not None:
            self.faults.check("flow.shed")
        return self._tenant(tenant_id).overload.current

    def force_mode(self, tenant_id: str, mode: str) -> None:
        """Pin a tenant's shed mode until cleared with "auto" (operator
        override — e.g. pre-emptively defer a tenant during an incident
        — and the deterministic lever tests drive transitions with)."""
        if mode == "auto":
            self._tenant(tenant_id).overload.forced = None
            return
        if mode not in SHED_MODES:
            raise ValueError(f"unknown shed mode {mode!r}")
        self._tenant(tenant_id).overload.forced = mode

    def count_shed(self, tenant_id: str, mode: str, n: float) -> None:
        self.count(f"shed_{mode}", tenant_id, n)

    # -- introspection -------------------------------------------------------

    def modes(self) -> dict[str, dict]:
        """Every known tenant's live shed state (mode + pressure +
        forced override) — the telemetry beat's per-tenant flow sample
        (kernel/observe.py). Read-only: never creates tenant state."""
        return {tid: {"mode": tf.overload.current,
                      "pressure": round(tf.overload.pressure, 4),
                      "forced": tf.overload.forced}
                for tid, tf in self._tenants.items()}

    def quota(self, tenant_id: str) -> dict:
        tf = self._tenant(tenant_id)
        out = {
            "tenant_id": tenant_id,
            "rate": tf.bucket.rate if tf.bucket else 0.0,
            "burst": tf.bucket.burst if tf.bucket else 0.0,
            "weight": tf.weight,
            "tokens": round(tf.bucket.tokens, 1) if tf.bucket else None,
            "mode": tf.overload.current,
            "forced": tf.overload.forced,
            "pressure": round(tf.overload.pressure, 4),
        }
        if self.metrics is not None:
            # direct counter reads: a registry snapshot() would compute
            # quantiles for every histogram just to fetch six counters
            for name in ("admitted", "rejected", "throttled",
                         "shed_degrade", "shed_defer",
                         "deferred_replayed"):
                out[name] = self.metrics.counter(
                    f"flow.{name}:{tenant_id}").value
        return out
