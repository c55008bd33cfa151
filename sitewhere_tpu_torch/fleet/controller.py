"""Fleet controller: placement, liveness, and the autoscaling loop.

One controller runs beside the broker (its runtime owns the in-proc
`EventBus` the `BusServer` serves), consuming the fleet-control topic:

- **liveness** — a worker silent past `fleet_dead_after_s` is declared
  dead; its tenants reassign in the next placement epoch and the new
  owners adopt immediately (a dead worker cannot be waited on).
- **placement** — weighted rendezvous over live, non-retiring workers
  (`parallel/placement.py`), tenant weights from the flow config,
  plus explicit per-tenant overrides (operator or autoscaler
  migrations). Every epoch is PUBLISHED on the control topic with the
  previous *actual* owner map, so each worker independently applies
  the same drain-then-handoff protocol (worker.py) and the whole fleet
  converges on one map.
- **autoscaling** — the ADApt replica-prediction shape (PAPERS.md,
  arXiv 2504.03698): per-tenant consumer-group lag read centrally off
  the broker bus (`EventBus.group_lags()` — the flight recorder's
  signal, built for exactly this) joined with each worker's heartbeat signals (egress
  backlog, scoring occupancy, DLQ count). Decisions — add-replica,
  remove-replica (drain-retire the coolest worker), migrate-tenant
  (move the laggiest tenant off the hottest worker) — carry hysteresis
  and a cooldown so backlog spikes don't flap the fleet. Actuation is
  a pluggable `spawner` callback (bench/CLI spawn OS processes; tests
  spawn in-proc runtimes); without one, decisions are advisory and
  recorded in `snapshot()`.

Epoch recovery: a supervised controller restart re-reads the latest
placement record off the control topic (`bus.peek`) before publishing
anything, so epochs never regress and workers never see a second
epoch-0.
"""

from __future__ import annotations

import logging
import time
from dataclasses import asdict, dataclass
from typing import Callable, Optional

from sitewhere_tpu_torch.kernel import dlq
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import (
    BackgroundTaskComponent,
    LifecycleComponent,
)
from sitewhere_tpu_torch.parallel.placement import compute_placement, placement_moves

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class AutoscalerPolicy:
    """Replica/migration policy (thresholds on backlog signals).

    `scale_up_lag` / `scale_down_lag` are consumer-lag-per-live-worker
    bounds (events committed-behind-head, summed over tenant groups);
    `hysteresis` shrinks the down-threshold so the fleet does not flap
    at the boundary, `cooldown_s` spaces decisions, and
    `imbalance_ratio` is the hottest-vs-coolest worker load ratio past
    which one migration beats a whole new replica (the hot worker must
    also carry at least `scale_down_lag` of load — a tiny skew is not
    worth a handoff)."""

    min_workers: int = 1
    max_workers: int = 8
    scale_up_lag: float = 5000.0
    scale_down_lag: float = 500.0
    hysteresis: float = 0.8
    cooldown_s: float = 10.0
    imbalance_ratio: float = 3.0


@dataclass
class _WorkerState:
    last_seen: float
    seq: int = 0
    epoch: int = -1
    owned: tuple = ()
    pending: tuple = ()
    blocked: tuple = ()
    ready: bool = False
    signals: dict = None  # type: ignore[assignment]


class FleetController(LifecycleComponent):
    """The fleet's brain (child of the broker-side runtime)."""

    def __init__(self, runtime, *, policy: Optional[AutoscalerPolicy] = None,
                 spawner: Optional[Callable[[], None]] = None,
                 interval_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None,
                 headroom: float = 1.25):
        super().__init__("fleet-controller")
        self.runtime = runtime
        settings = runtime.settings
        self.policy = policy or AutoscalerPolicy()
        self.spawner = spawner
        self.interval_s = (interval_s if interval_s is not None
                           else getattr(settings, "fleet_interval_s", 0.5))
        self.dead_after_s = (dead_after_s if dead_after_s is not None
                             else getattr(settings, "fleet_dead_after_s", 5.0))
        self.headroom = headroom
        self.control_topic = runtime.naming.instance_topic(
            TopicNaming.FLEET_CONTROL)
        self.tenants: dict = {}                 # tid -> TenantConfig
        self.overrides: dict[str, str] = {}     # tid -> worker (migrations)
        self.workers: dict[str, _WorkerState] = {}
        self.retiring: set[str] = set()
        self.owners: dict[str, str] = {}        # best-known ACTUAL owner
        self.epoch = 0
        self.assignment: dict[str, str] = {}
        self.rebalances = 0
        self.decisions: list[dict] = []         # autoscaler audit trail
        self._last_scale_t = -1e9
        self._spawned_at = -1e9
        self._pending_spawns = 0
        self._last_publish_t = -1e9
        self._stuck_since: dict[str, float] = {}
        self._dirty = False
        self._force_epoch = False
        self._last_tick: Optional[float] = None
        self._loop = _ControllerLoop(self)
        self.add_child(self._loop)
        # fleet observability plane (fleet/observer.py): the broker
        # host folds every worker's exported telemetry beats into the
        # fleet-wide critical path / lag matrix / mesh occupancy view
        # (`GET /api/fleet/observe`, `swx top --fleet`); rides the
        # runtime's observe lever — `observe_enabled: false` turns the
        # whole recorder off, fleet merge included
        self.observer = None
        if getattr(settings, "observe_enabled", True) \
                and getattr(settings, "fleet_observe", True):
            from sitewhere_tpu_torch.fleet.observer import FleetObserver

            self.observer = FleetObserver(runtime)
            self.add_child(self.observer)
        # predictive control plane (fleet/forecast.py): created lazily
        # on the first loop tick — it needs the runtime's durable
        # telemetry history, which the runtime attaches at start
        self.planner = None
        runtime.fleet = self  # REST `GET /api/fleet` + observe surface

    # -- tenant roster (the fleet's source of truth) -------------------------

    def add_tenant(self, tenant) -> None:
        """Register (or update) a tenant for placement; the next tick
        publishes the new map and the owning worker spins engines."""
        from sitewhere_tpu_torch.config import RESERVED_TENANT

        if tenant.tenant_id == RESERVED_TENANT:
            # the platform's internal tenant-0 (fleet/forecast.py) is
            # never placed: it scores on the controller host's own pool
            raise ValueError(
                f"tenant id {RESERVED_TENANT!r} is reserved for the "
                "platform's internal scoring slot")
        self.tenants[tenant.tenant_id] = tenant
        self._dirty = True

    def remove_tenant(self, tenant_id: str) -> None:
        self.tenants.pop(tenant_id, None)
        self.overrides.pop(tenant_id, None)
        self._dirty = True

    def migrate(self, tenant_id: str, worker_id: str) -> None:
        """Pin a tenant to a worker (operator/autoscaler migration);
        cleared automatically if the worker dies."""
        self.overrides[tenant_id] = worker_id
        self._dirty = True

    def retire_worker(self, worker_id: str) -> None:
        """Drain a worker: it keeps heartbeating but receives no
        assignments; once it owns nothing it flags itself retired."""
        if worker_id in self.workers:
            self.retiring.add(worker_id)
            self._dirty = True

    def request_replica(self) -> bool:
        """Spawn one worker through the configured actuator, counting
        it as in-flight until its first heartbeat — the floor check
        must not stack spawns while a booting process is still paying
        its interpreter/jax startup. Bench/tests pre-spawn through
        this too, so the count is shared."""
        if self.spawner is None:
            return False
        self.spawner()
        self._pending_spawns += 1
        self._spawned_at = time.monotonic()
        return True

    # -- control-record handling ---------------------------------------------

    def handle_control(self, value) -> None:
        kind = value["kind"] if isinstance(value, dict) else None
        now = time.monotonic()
        if kind == "heartbeat":
            wid = value["worker"]
            state = self.workers.get(wid)
            if state is None:
                state = self.workers[wid] = _WorkerState(last_seen=now)
                logger.info("fleet: worker %s joined", wid)
                self._pending_spawns = max(self._pending_spawns - 1, 0)
                self._dirty = True
            state.last_seen = now
            state.seq = int(value.get("seq", 0))
            state.epoch = int(value.get("epoch", -1))
            state.owned = tuple(value.get("owned") or ())
            state.pending = tuple(value.get("pending") or ())
            state.blocked = tuple(value.get("blocked") or ())
            state.ready = bool(value.get("ready", False))
            state.signals = dict(value.get("signals") or {})
            for tid in state.owned:
                self.owners[tid] = wid
            for tid in [t for t, w in self.owners.items()
                        if w == wid and t not in state.owned]:
                self.owners.pop(tid, None)
            if state.epoch < self.epoch:
                # late joiner / restarted worker behind the current
                # epoch: republish so it converges (bounded by interval)
                self._dirty = True
            elif state.epoch > self.epoch:
                # WE are behind (controller restart whose control-topic
                # peek was buried under heartbeats, or an emptied
                # broker): fast-forward — publishing an epoch at or
                # below what workers hold would be ignored fleet-wide
                logger.warning(
                    "fleet: worker %s reports epoch %d > ours %d; "
                    "fast-forwarding", wid, state.epoch, self.epoch)
                self.epoch = state.epoch
                self._dirty = True
        elif kind == "release":
            tid, wid = value["tenant"], value["worker"]
            if self.owners.get(tid) == wid:
                self.owners.pop(tid, None)
        elif kind == "leave":
            wid = value["worker"]
            if self.workers.pop(wid, None) is not None:
                logger.info("fleet: worker %s left", wid)
                self.retiring.discard(wid)
                self._forget_worker(wid)
                self._dirty = True
        # placement records are our own output; ignore

    def _forget_worker(self, wid: str) -> None:
        for tid in [t for t, w in self.owners.items() if w == wid]:
            self.owners.pop(tid, None)
        for tid in [t for t, w in self.overrides.items() if w == wid]:
            self.overrides.pop(tid, None)

    # -- liveness ------------------------------------------------------------

    def check_liveness(self) -> None:
        now = time.monotonic()
        prev_tick = self._last_tick
        stalled = (prev_tick is not None
                   and now - prev_tick > max(4 * self.interval_s, 1.0))
        self._last_tick = now
        if stalled:
            # OUR loop stalled (first-compile, GC, a co-resident loop
            # not yielding): the silence window is this process's lag,
            # not the workers' — a mass false-death here would hand
            # live workers' tenants away mid-ownership (the one race
            # that can violate drain-then-handoff). Grant a fresh
            # observation window instead.
            logger.warning(
                "fleet: controller tick stalled %.1fs; deferring "
                "liveness judgement one window", now - prev_tick)
            for state in self.workers.values():
                state.last_seen = max(state.last_seen, now)
            return
        for wid, state in list(self.workers.items()):
            # adopting grace: a worker that last reported a handoff in
            # progress may be blocked in an engine start (first jit
            # compile runs for tens of seconds) — it cannot heartbeat
            # through that, and declaring it dead would bounce the
            # tenant to another worker that stalls the same way (the
            # death/respawn cascade the first fleet bench measured)
            bound = self.dead_after_s * (5.0 if state.pending else 1.0)
            if now - state.last_seen > bound:
                logger.warning(
                    "fleet: worker %s dead (silent %.1fs > %.1fs); "
                    "reassigning its tenants", wid,
                    now - state.last_seen, bound)
                self.workers.pop(wid, None)
                self.retiring.discard(wid)
                self._forget_worker(wid)
                self.runtime.metrics.counter("fleet.worker_deaths").inc()
                self._dirty = True

    # -- placement -----------------------------------------------------------

    def _placing_workers(self) -> list[str]:
        return sorted(w for w in self.workers if w not in self.retiring)

    def compute(self) -> dict[str, str]:
        placing = self._placing_workers()
        weights = {
            tid: float(cfg.section("flow").get("weight", 1.0) or 1.0)
            for tid, cfg in self.tenants.items()}
        assignment = compute_placement(weights, placing,
                                       headroom=self.headroom)
        for tid, wid in self.overrides.items():
            if tid in assignment and wid in placing:
                assignment[tid] = wid
        return assignment

    async def publish_placement(self, reason: str, *,
                                force_epoch: bool = False) -> None:
        new = self.compute()
        changed = new != self.assignment
        if not changed and not force_epoch:
            if self._behind_workers():
                await self._produce_placement(reason + " (republish)")
            return
        if self.runtime.faults is not None:
            # chaos seam: a crashed publish restarts the loop; epoch
            # recovery (peek) keeps the sequence monotonic
            await self.runtime.faults.acheck("fleet.rebalance")
        moves = placement_moves(self.assignment, new)
        self.epoch += 1
        self.assignment = new
        self.rebalances += 1
        metrics = self.runtime.metrics
        metrics.counter("fleet.rebalances").inc()
        metrics.gauge("fleet.placement_epoch").set(self.epoch)
        logger.info("fleet: placement epoch %d (%s): %d tenants over %d "
                    "workers, %d moves", self.epoch, reason,
                    len(new), len(self._placing_workers()), len(moves))
        await self._produce_placement(reason)

    def _behind_workers(self) -> bool:
        return any(s.epoch < self.epoch for s in self.workers.values())

    async def _produce_placement(self, reason: str) -> None:
        await self.runtime.bus.produce(self.control_topic, {
            "kind": "placement",
            "epoch": self.epoch,
            "assignment": dict(self.assignment),
            "prev": dict(self.owners),
            "workers": sorted(self.workers),
            "retiring": sorted(self.retiring),
            "tenants": dict(self.tenants),
            "reason": reason,
            "t": time.time(),
        }, key="placement")
        self._last_publish_t = time.monotonic()

    def heal_stuck_handoffs(self) -> None:
        """A handoff can wedge when a release lands under an older
        epoch than the adopter is waiting on (racing rebalances). The
        owner map already shows the tenant free; bump the epoch so the
        adopter's exact-epoch release check re-evaluates against a
        prev map without the stale owner."""
        now = time.monotonic()
        grace = max(2 * self.interval_s, 1.0)
        stuck = False
        for tid, wid in self.assignment.items():
            state = self.workers.get(wid)
            # blocked (the assignee cannot match a release to the
            # current epoch) + owner-free (the release DID happen) is
            # the wedge; merely-pending means engines are starting —
            # bumping the epoch under a compiling adopter is noise
            waiting = (state is not None and tid in state.blocked
                       and self.owners.get(tid) is None)
            if waiting:
                since = self._stuck_since.setdefault(tid, now)
                if now - since > grace:
                    stuck = True
            else:
                self._stuck_since.pop(tid, None)
        if stuck and now - self._last_publish_t > grace:
            self._stuck_since.clear()
            self._dirty = True
            self._force_epoch = True

    # -- autoscaler (ADApt replica-prediction shape) -------------------------

    def tenant_lags(self) -> dict[str, int]:
        """Per-tenant consumer lag read centrally off the broker bus
        (tenant consumer groups are `{tenant}.{service}`),
        EVENT-weighted: scaling decisions must see the queue in events,
        not record offsets — a backlog of columnar batches is invisible
        in offset units (one 1024-row batch = 1 offset)."""
        group_lags = getattr(self.runtime.bus, "group_lags", None)
        if group_lags is None:
            return {}
        lags: dict[str, int] = {tid: 0 for tid in self.tenants}
        try:
            by_group = group_lags(events=True)
        except TypeError:  # wire-proxied bus: record units only
            by_group = group_lags()
        for group, by_topic in by_group.items():
            tid, _, _ = group.partition(".")
            if tid in lags:
                lags[tid] += sum(by_topic.values())
        return lags

    def worker_loads(self, lags: Optional[dict[str, int]] = None
                     ) -> dict[str, float]:
        """Per-worker load: owned tenants' lag + the worker's own
        backlog/occupancy heartbeat signals. Pass precomputed `lags`
        to avoid a second broker-wide group sweep per tick."""
        if lags is None:
            lags = self.tenant_lags()
        loads: dict[str, float] = {}
        for wid in self._placing_workers():
            state = self.workers[wid]
            load = float(sum(lags.get(t, 0) for t in state.owned))
            sig = state.signals or {}
            load += sig.get("egress_backlog", 0) \
                + sig.get("scoring_pending", 0)
            loads[wid] = load
        return loads

    def decide(self, loads: dict[str, float],
               lags: dict[str, int]) -> Optional[dict]:
        """One autoscaler decision (or None): pure function of the
        signals so tests pin the hysteresis/cooldown behavior."""
        policy = self.policy
        live_n = len(loads)
        now = time.monotonic()
        if self._pending_spawns and now - self._spawned_at > 60.0:
            # a spawned process never heartbeated (boot crash): stop
            # counting it, or the floor could never re-spawn
            self._pending_spawns = 0
        if live_n + self._pending_spawns < policy.min_workers:
            # below floor (a worker died): replace immediately;
            # in-flight spawns count, so a booting replacement is not
            # stacked with another one every tick
            return {"action": "add_replica",
                    "reason": f"{live_n} live + {self._pending_spawns} "
                              f"booting < min {policy.min_workers}"}
        if now - self._last_scale_t < policy.cooldown_s or not live_n:
            return None
        per_worker = sum(loads.values()) / live_n
        if per_worker > policy.scale_up_lag \
                and live_n + self._pending_spawns < policy.max_workers:
            return {"action": "add_replica",
                    "reason": f"load/worker {per_worker:.0f} > "
                              f"{policy.scale_up_lag:.0f}"}
        if live_n > policy.min_workers \
                and per_worker < policy.scale_down_lag * policy.hysteresis:
            coolest = min(loads, key=lambda w: (loads[w], w))
            return {"action": "remove_replica", "worker": coolest,
                    "reason": f"load/worker {per_worker:.0f} < "
                              f"{policy.scale_down_lag * policy.hysteresis:.0f}"}
        if live_n >= 2:
            hottest = max(loads, key=lambda w: (loads[w], w))
            coolest = min(loads, key=lambda w: (loads[w], w))
            imbalanced = (loads[hottest] >= policy.scale_down_lag
                          and loads[hottest] > policy.imbalance_ratio
                          * max(loads[coolest], 1.0))
            if imbalanced and coolest != hottest:
                state = self.workers.get(hottest)
                owned = [t for t in (state.owned if state else ())
                         if t in self.tenants]
                if len(owned) > 1:  # moving a lone tenant changes nothing
                    tid = max(owned, key=lambda t: (lags.get(t, 0), t))
                    return {"action": "migrate_tenant", "tenant": tid,
                            "worker": coolest,
                            "reason": f"{hottest} load "
                                      f"{loads[hottest]:.0f} > "
                                      f"{policy.imbalance_ratio}× "
                                      f"{coolest}'s {loads[coolest]:.0f}"}
        return None

    def _ensure_planner(self) -> None:
        """Create the predictive planner on first use (fleet/forecast.py):
        gated on the forecast lever AND the durable telemetry history —
        without the history there is nothing to train or serve from,
        and the reactive path alone runs (the fallback floor)."""
        if self.planner is not None:
            return
        if not getattr(self.runtime.settings, "fleet_forecast", True):
            return
        if getattr(self.runtime, "history", None) is None:
            return
        from sitewhere_tpu_torch.fleet.forecast import PredictivePlanner

        self.planner = PredictivePlanner(self)

    def autoscale(self) -> Optional[dict]:
        lags = self.tenant_lags()
        loads = self.worker_loads(lags)
        # predictive first (decisions carry forecast provenance into the
        # same audit trail), reactive as the fallback floor — the
        # planner returns None whenever its confidence gate demotes
        decision = (self.planner.decide(loads, lags)
                    if self.planner is not None else None)
        if decision is None:
            decision = self.decide(loads, lags)
        if decision is None:
            return None
        now = time.monotonic()
        decision["t"] = time.time()
        decision["actuated"] = False
        metrics = self.runtime.metrics
        action = decision["action"]
        if self.spawner is not None:
            # actuation requires the full actuator: retiring or
            # migrating without a spawner would let a quiet fleet
            # drain itself down with no scale-up path back (the
            # documented contract: no spawner → advisory only)
            if action == "add_replica":
                if self.request_replica():
                    metrics.counter("fleet.autoscale_up").inc()
                    decision["actuated"] = True
            elif action == "remove_replica":
                self.retire_worker(decision["worker"])
                metrics.counter("fleet.autoscale_down").inc()
                decision["actuated"] = True
            elif action == "migrate_tenant":
                self.migrate(decision["tenant"], decision["worker"])
                decision["actuated"] = True
        self._last_scale_t = now
        self.decisions.append(decision)
        del self.decisions[:-32]
        logger.info("fleet autoscaler: %s (%s)%s", action,
                    decision["reason"],
                    "" if decision["actuated"] else " [advisory]")
        return decision

    # -- status (REST `GET /api/fleet`, `swx fleet status`, observe) ---------

    def snapshot(self) -> dict:
        now = time.monotonic()
        workers = {}
        for wid, state in sorted(self.workers.items()):
            workers[wid] = {
                "ready": state.ready,
                "owned": sorted(state.owned),
                "pending": sorted(state.pending),
                "epoch": state.epoch,
                "last_heartbeat_age_s": round(now - state.last_seen, 3),
                "retiring": wid in self.retiring,
                "signals": state.signals or {},
            }
        unplaced = sorted(set(self.tenants) - set(self.assignment))
        converged = (not unplaced and all(
            self.owners.get(tid) == wid
            for tid, wid in self.assignment.items()))
        self.runtime.metrics.gauge("fleet.workers_live").set(
            len(self.workers))
        self.runtime.metrics.gauge("fleet.tenants_pending").set(
            len(self.tenants) - len(
                [t for t in self.assignment if self.owners.get(t)]))
        fences = getattr(self.runtime.bus, "fences", None)
        return {
            "epoch": self.epoch,
            "workers": workers,
            "assignment": dict(sorted(self.assignment.items())),
            "owners": dict(sorted(self.owners.items())),
            "tenants": sorted(self.tenants),
            "unplaced": unplaced,
            "converged": converged,
            "rebalances": self.rebalances,
            "overrides": dict(sorted(self.overrides.items())),
            "autoscaler": {
                "policy": asdict(self.policy),
                "decisions": self.decisions[-8:],
            },
            # predictive control plane (fleet/forecast.py): gate state,
            # horizon-error EMA, and live per-tenant forecasts — the
            # brief rendered by `swx top --fleet`; the full view is
            # `GET /api/fleet/forecast`
            "forecast": (self.planner.snapshot()
                         if self.planner is not None else None),
            # epoch fencing (docs/FLEET.md): the broker-side authority's
            # allowed-writer view + rejected-zombie-write count — absent
            # until the first placement record builds the authority
            "fencing": (None if fences is None else {
                "rejections": fences.rejections,
                "owners": {t: {"worker": w, "epoch": e}
                           for t, (w, e) in sorted(fences.owners.items())},
                "pending": {t: {"worker": w, "epoch": e}
                            for t, (w, e)
                            in sorted(fences.pending.items())},
            }),
        }


class _ControllerLoop(BackgroundTaskComponent):
    """The controller's single supervised loop."""

    def __init__(self, controller: FleetController):
        super().__init__("loop")
        self.controller = controller

    async def _run(self) -> None:
        c = self.controller
        rt = c.runtime
        # epoch recovery: never reissue an epoch workers already saw
        peek = getattr(rt.bus, "peek", None)
        if peek is not None:
            for record in reversed(peek(c.control_topic, limit=500)):
                v = record.value
                if isinstance(v, dict) and v.get("kind") == "placement" \
                        and int(v.get("epoch", -1)) >= c.epoch:
                    c.epoch = int(v["epoch"])
                    c.assignment = dict(v.get("assignment") or {})
                    break
        consumer = rt.bus.subscribe(
            c.control_topic, group="fleet.controller",
            name="fleet.controller")
        try:
            while True:
                records = await consumer.poll(timeout=c.interval_s)
                for record in records:
                    try:
                        c.handle_control(record.value)
                    except Exception as exc:  # noqa: BLE001 - poison isolated
                        await dlq.quarantine(
                            rt.bus,
                            rt.naming.instance_topic(TopicNaming.DEAD_LETTER),
                            record, exc, self.path, metrics=rt.metrics)
                consumer.commit()
                c.check_liveness()
                c.heal_stuck_handoffs()
                if c._dirty and (c.workers or not c.tenants):
                    # clear the flags only AFTER the publish lands: a
                    # crash mid-publish (fleet.rebalance chaos) must
                    # leave the rebalance pending for the restarted loop
                    await c.publish_placement(
                        "roster/membership change",
                        force_epoch=c._force_epoch)
                    c._dirty = False
                    c._force_epoch = False
                c._ensure_planner()
                if c.planner is not None:
                    # serve + admit BEFORE deciding: the freshest closed
                    # window rides into this tick's forecasts
                    await c.planner.tick()
                c.autoscale()
        finally:
            if c.planner is not None:
                c.planner.close()
            consumer.close()
