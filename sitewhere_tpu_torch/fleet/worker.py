"""Fleet worker: apply placement to one runtime, heartbeat liveness.

A `FleetWorker` rides a `fleet_managed` ServiceRuntime as a lifecycle
child and is the ONLY thing that starts or stops tenant engines there.
Two supervised loops share its state:

- the **control loop** consumes the fleet-control topic (own consumer
  group per worker — broadcast semantics), records placement epochs and
  release acknowledgements, and publishes a heartbeat every
  `fleet_heartbeat_s` carrying the TelemetryBeat-derived signals the
  controller's autoscaler reads (egress backlog, scoring occupancy,
  DLQ count, loop lag) plus the owned/pending tenant sets;
- the **apply loop** converges local ownership onto the latest
  placement: tenants this worker lost are released FIRST
  (`ServiceRuntime.release_tenant` — consumers stop, settle barriers
  commit through, then a release record is published), and tenants it
  gained are adopted only once safe (previous owner released at this
  epoch, is dead — absent from the placement's live-worker list — or
  never existed). That ordering is the no-dual-ownership invariant:
  two workers never consume one tenant's topics at the same time, and
  the adopter resumes from the group's committed offsets
  (at-least-once across the handoff, the lane toggles' property).

A worker asked to retire (absent from the placement's worker list)
releases everything and sets `retired`; the process entry
(worker_main.py) exits on that flag. A graceful stop releases owned
tenants and publishes a `leave`, so the controller reassigns
immediately instead of waiting out the dead-after window.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from sitewhere_tpu_torch.kernel import dlq
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import (
    BackgroundTaskComponent,
    LifecycleComponent,
    LifecycleProgressMonitor,
)

logger = logging.getLogger(__name__)


class FleetWorker(LifecycleComponent):
    """One worker's membership in the fleet (child of its runtime)."""

    def __init__(self, runtime, worker_id: str, *,
                 heartbeat_s: Optional[float] = None):
        super().__init__(f"fleet-worker-{worker_id}")
        self.runtime = runtime
        self.worker_id = worker_id
        settings = runtime.settings
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None
                            else getattr(settings, "fleet_heartbeat_s", 1.0))
        self.control_topic = runtime.naming.instance_topic(
            TopicNaming.FLEET_CONTROL)
        # latest placement view (control loop writes, apply loop reads)
        self.epoch = -1
        self.assignment: dict[str, str] = {}
        self.prev: dict[str, str] = {}
        self.workers_live: list[str] = []
        self.retiring_list: list[str] = []
        self.tenant_configs: dict = {}
        self.releases: set[tuple[str, int]] = set()
        # local ownership state (apply loop writes)
        self.owned: set[str] = set()
        self.retired = False
        # set once a placement's live-worker list includes us:
        # retirement means "the fleet excluded ME", and a fresh worker
        # catching up on control-topic history (its first poll may end
        # mid-replay, on an epoch from before it existed) must never
        # read an old placement as its own exclusion and exit
        self._joined_placement = False
        self.adopted_at: dict[str, float] = {}    # diagnostics/tests
        self.released_at: dict[str, float] = {}
        self._move_started: dict[str, float] = {}  # pending → handoff_s
        # epoch fencing (docs/FLEET.md): tenants whose data-path writes
        # the broker REJECTED (we are a zombie owner — false-positive
        # death, stalled loop) mapped to the epoch we held when fenced;
        # the apply loop stops their engines and refuses to re-adopt
        # until a strictly newer placement assigns them here again
        self._fenced_at: dict[str, int] = {}
        # tenants whose memberships the broker evicted (we were dropped
        # from a placement's live list): their engines are stopped and,
        # if still assigned here, adopted again with fresh memberships
        self._evicted: set[str] = set()
        runtime.fence.worker_id = worker_id
        runtime.fence.on_lost = self._on_fence_lost
        # fleet-wide trace identity (kernel/tracing.py): ids this worker
        # MINTS carry its origin in the high bits, so a fleet-merged
        # trace view can never conflate two workers' dense counters —
        # ids stamped elsewhere (the ingress host) ride batches through
        # unchanged, ONE trace id across the whole spine
        runtime.tracer.set_origin(worker_id)
        self._dirty = asyncio.Event()
        self._seq = 0
        self._control = _WorkerControlLoop(self)
        self._apply = _WorkerApplyLoop(self)
        self.add_child(self._control)
        self.add_child(self._apply)

    def _on_fence_lost(self, tenant_id: str) -> None:
        """FenceState callback (sync, any loop): a broker rejected our
        write for this tenant — schedule the engine stop."""
        self._fenced_at[tenant_id] = self.epoch
        self._dirty.set()

    # -- views ---------------------------------------------------------------

    def assigned_to_me(self) -> set[str]:
        return {t for t, w in self.assignment.items()
                if w == self.worker_id}

    def pending(self) -> set[str]:
        """Assigned here but not yet adopted (waiting on a release)."""
        return self.assigned_to_me() - self.owned

    # -- control-record handling (called by the control loop) ----------------

    def handle_control(self, value) -> None:
        kind = value["kind"] if isinstance(value, dict) else None
        if kind == "placement":
            epoch = int(value["epoch"])
            if epoch < self.epoch:
                return  # stale republish
            self.epoch = epoch
            self.assignment = dict(value["assignment"])
            self.prev = dict(value.get("prev") or {})
            self.workers_live = list(value.get("workers") or [])
            self.retiring_list = list(value.get("retiring") or [])
            if self.worker_id in self.workers_live:
                self._joined_placement = True
            cfgs = value.get("tenants")
            if cfgs is not None:
                # the record carries the FULL roster: replace, don't
                # merge — deleted tenants' configs must not accumulate
                # for the worker's lifetime
                self.tenant_configs = dict(cfgs)
            # releases older than the live epoch can never satisfy
            # _adoptable again — without pruning, a long-running worker
            # retains every release record it ever saw
            self.releases = {(t, e) for t, e in self.releases
                             if e >= epoch}
            # a fence recorded at an OLDER epoch is cleared by a newer
            # placement: if that placement assigns the tenant here, the
            # adoption is a legitimate fresh grant, not a zombie retry
            self._fenced_at = {t: e for t, e in self._fenced_at.items()
                               if e >= epoch}
            if self.worker_id not in self.workers_live:
                # declared dead while we were only stalled: the broker
                # evicted every membership we hold on this record
                # (`EventBus.evict_owner`), so our engines read nothing
                # from here on, even if a later record (read before the
                # apply loop runs) assigns the tenants here again
                self._evicted |= self.owned
            now = time.monotonic()
            for tid in self.pending():
                self._move_started.setdefault(tid, now)
            self._dirty.set()
        elif kind == "release":
            self.releases.add((value["tenant"], int(value["epoch"])))
            self._dirty.set()
        # heartbeats/leaves are controller input; unknown kinds are
        # forward-compatible no-ops

    def _adoptable(self, tenant_id: str) -> bool:
        prev_owner = self.prev.get(tenant_id)
        if prev_owner in (None, self.worker_id):
            return True
        if prev_owner not in self.workers_live:
            return True  # dead/left: controller auto-released its shard
        return (tenant_id, self.epoch) in self.releases

    # -- heartbeat -----------------------------------------------------------

    def signals(self) -> dict:
        """TelemetryBeat-derived load signals for the autoscaler."""
        out: dict = {"dlq": int(self.runtime.metrics.counter(
            "dlq.quarantined").value)}
        beat = getattr(self.runtime, "beat", None)
        sample = beat.samples[-1] if beat is not None and beat.samples \
            else None
        if sample is not None:
            out["loop_lag_ms"] = sample.get("loop_lag_ms", 0.0)
            out["egress_backlog"] = sum(
                (sample.get("egress_backlog") or {}).values())
            scoring = sample.get("scoring") or {}
            out["scoring_pending"] = sum(
                s.get("pending", 0) for s in scoring.values())
            out["scoring_inflight"] = sum(
                s.get("inflight", 0) for s in scoring.values())
        bus = self.runtime.bus
        if hasattr(bus, "wire_stats"):
            # wire fast-path surface (kernel/wire.py): the client-side
            # fire-and-forget window + coalescing counters ride every
            # heartbeat, so the controller (and `swx fleet status`) see
            # a worker throttled by broker backpressure as such rather
            # than as a mysteriously lagging one
            ws = bus.wire_stats()
            out["wire_ff_pending"] = ws["ff_pending"]
            out["wire_backlogged"] = ws["backlogged"]
        if sample is not None:
            mesh = sample.get("mesh") or []
            if mesh:
                # per-device mesh telemetry (scoring/pool.py
                # mesh_stats): the dispatch path's occupancy + live
                # tflops ride every heartbeat, so the controller (and
                # `swx fleet status`) read the SPMD serving state live
                out["mesh_occupancy"] = max(
                    b.get("row_occupancy", 0.0) for b in mesh)
                out["model_tflops_per_device"] = max(
                    b.get("model_tflops_per_device", 0.0) for b in mesh)
        return out

    async def heartbeat(self) -> None:
        self._seq += 1
        pending = sorted(self.pending())
        await self.runtime.bus.produce(self.control_topic, {
            "kind": "heartbeat",
            "worker": self.worker_id,
            "seq": self._seq,
            "epoch": self.epoch,
            "owned": sorted(self.owned),
            "pending": pending,
            # pending tenants whose previous owner has not released at
            # THIS epoch: the stuck-handoff healer's trigger (pending
            # but adoptable just means the engines are still starting)
            "blocked": [t for t in pending if not self._adoptable(t)],
            "ready": not pending,
            "signals": self.signals(),
            "t": time.time(),
        }, key=self.worker_id)
        self.runtime.metrics.counter("fleet.heartbeats").inc()

    # -- ownership convergence (called by the apply loop) --------------------

    async def apply(self) -> None:
        rt = self.runtime
        mine = self.assigned_to_me()
        metrics = rt.metrics
        # fenced first: the broker REJECTED our data-path writes for
        # these tenants — we are a zombie owner (false-positive death).
        # Stop the engines now and publish NO release: the fence already
        # transferred ownership, and a release under our stale epoch
        # would only confuse adopters. Offsets were never advanced by
        # us past the fence, so the real owner resumes exactly where
        # the broker last accepted a commit.
        for tid in sorted(set(self._fenced_at) & self.owned):
            logger.warning("%s: tenant %s FENCED (ownership moved while "
                           "we were stalled) — stopping engines, not "
                           "retrying", self.name, tid)
            await rt.release_tenant(tid)
            self.owned.discard(tid)
            rt.fence.revoke(tid)
        # evicted next, the same way (no release: the authority moved the
        # grants when the placement dropped us); those still assigned
        # here are adopted again below
        evicted, self._evicted = self._evicted & self.owned, set()
        for tid in sorted(evicted):
            logger.warning("%s: tenant %s's memberships were evicted (we "
                           "were declared dead) — stopping its engines",
                           self.name, tid)
            await rt.release_tenant(tid)
            self.owned.discard(tid)
            rt.fence.revoke(tid)
        # release next: the loser drains and commits BEFORE any adopter
        # may start — the ordering that makes dual-ownership impossible
        for tid in sorted(self.owned - mine):
            if self.assignment.get(tid) == self.worker_id:
                continue  # a newer epoch gave it back mid-pass
            await rt.release_tenant(tid)
            self.owned.discard(tid)
            rt.fence.revoke(tid)
            self.released_at[tid] = time.monotonic()
            metrics.counter("fleet.releases").inc()
            await rt.bus.produce(self.control_topic, {
                "kind": "release", "worker": self.worker_id,
                "tenant": tid, "epoch": self.epoch,
            }, key=tid)
            logger.info("%s: released tenant %s (epoch %d)",
                        self.name, tid, self.epoch)
        for tid in sorted(mine - self.owned):
            if self.assignment.get(tid) != self.worker_id:
                # a newer epoch landed while an earlier adopt in this
                # pass was compiling and moved this tenant elsewhere —
                # acting on the stale view would dual-own it with the
                # new assignee (who sees it owner-free and adopts)
                continue
            if self._fenced_at.get(tid, -1) >= self.epoch \
                    and (tid, self.epoch) not in self.releases:
                # fenced at this (or a newer) epoch: our placement view
                # is the stale one — only a strictly newer epoch that
                # assigns the tenant here again may re-adopt it, or a
                # release at this epoch: a same-epoch republish whose
                # `prev` named a live owner still finishing a stale
                # adopt moved the broker's grant back to it (our writes
                # fenced), and its release hands the grant to us again
                # (FenceAuthority promotes the pending adopter), as
                # `_adoptable` reads it. Without this the tenant waits
                # for an epoch bump nothing triggers: we report it
                # pending but not blocked, so the controller's healer
                # never fires
                continue
            if not self._adoptable(tid):
                continue  # wait for the previous owner's release
            cfg = self.tenant_configs.get(tid)
            if cfg is None:
                logger.warning("%s: assigned %s but no config in the "
                               "placement record yet", self.name, tid)
                continue
            # engine start can block this process for many seconds
            # (first jit compile); a fresh heartbeat — carrying the
            # non-empty `pending` set — buys the adopting-grace
            # liveness window (controller: dead_after × grace while a
            # worker reports a handoff in progress)
            await self.heartbeat()
            if self.assignment.get(tid) != self.worker_id:
                continue  # a newer epoch landed during the heartbeat
            # the fencing grant precedes the engine start: the engines'
            # first produce/commit must already carry this epoch's token
            self._fenced_at.pop(tid, None)
            rt.fence.grant(tid, self.epoch)
            await rt.adopt_tenant(cfg)
            if self.assignment.get(tid) != self.worker_id:
                # the epoch moved this tenant away while our engines
                # were starting: hand it straight back — the new
                # assignee may already be waiting on our release (and
                # one that adopted through a prev-owner-free view
                # overlaps us until this lands; delivery stays
                # at-least-once through the shared consumer group,
                # and the fence authority keeps US the allowed writer
                # until this release record lands)
                await rt.release_tenant(tid)
                rt.fence.revoke(tid)
                await rt.bus.produce(self.control_topic, {
                    "kind": "release", "worker": self.worker_id,
                    "tenant": tid, "epoch": self.epoch,
                }, key=tid)
                metrics.counter("fleet.releases").inc()
                continue
            self.owned.add(tid)
            now = time.monotonic()
            self.adopted_at[tid] = now
            started = self._move_started.pop(tid, now)
            metrics.counter("fleet.handoffs").inc()
            metrics.histogram("fleet.handoff_s").observe(now - started)
            logger.info("%s: adopted tenant %s (epoch %d)",
                        self.name, tid, self.epoch)
        # config updates for tenants this worker keeps: a changed config
        # respins the engines through the same equivalence guard the
        # broadcast path uses
        for tid in sorted(mine & self.owned):
            cfg = self.tenant_configs.get(tid)
            current = rt.tenants.get(tid)
            if cfg is not None and current is not None \
                    and not current.equivalent(cfg):
                await rt.adopt_tenant(cfg)
        excluded = (self.worker_id not in self.workers_live
                    or self.worker_id in self.retiring_list)
        if self._joined_placement and self.epoch >= 0 and excluded \
                and not self.owned:
            # asked to retire (scale-down: on the placement's retiring
            # list — it keeps us in `workers` so peers still wait for
            # our releases — or dropped from the fleet entirely):
            # everything released, the process entry exits on this flag
            self.retired = True

    # -- graceful departure --------------------------------------------------

    async def _do_stop(self, monitor: LifecycleProgressMonitor) -> None:
        await super()._do_stop(monitor)
        # loops are stopped (children stop first); drain owned tenants
        # so the engines commit through, then tell the controller we
        # left — it reassigns immediately instead of waiting out the
        # dead-after window
        try:
            for tid in sorted(self.owned):
                await self.runtime.release_tenant(tid)
                self.owned.discard(tid)
                self.runtime.fence.revoke(tid)
                await self.runtime.bus.produce(self.control_topic, {
                    "kind": "release", "worker": self.worker_id,
                    "tenant": tid, "epoch": self.epoch,
                }, key=tid)
            await self.runtime.bus.produce(self.control_topic, {
                "kind": "leave", "worker": self.worker_id,
                "epoch": self.epoch,
            }, key=self.worker_id)
        except Exception:  # noqa: BLE001 - the bus may already be down
            logger.debug("%s: could not announce leave (bus down?)",
                         self.name, exc_info=True)


class _WorkerControlLoop(BackgroundTaskComponent):
    """Consume fleet-control + publish heartbeats (one supervised loop)."""

    def __init__(self, worker: FleetWorker):
        super().__init__("control")
        self.worker = worker

    async def _run(self) -> None:
        w = self.worker
        rt = w.runtime
        consumer = rt.bus.subscribe(
            w.control_topic, group=f"fleet.worker.{w.worker_id}",
            name=f"fleet.worker.{w.worker_id}")
        try:
            await w.heartbeat()  # announce membership immediately
            next_hb = time.monotonic() + w.heartbeat_s
            while True:
                records = await consumer.poll(
                    timeout=max(min(w.heartbeat_s / 2, 0.5), 0.02))
                for record in records:
                    try:
                        w.handle_control(record.value)
                    except Exception as exc:  # noqa: BLE001 - poison isolated
                        # instance-scoped control records quarantine to
                        # the instance dead-letter topic with provenance
                        await dlq.quarantine(
                            rt.bus,
                            rt.naming.instance_topic(TopicNaming.DEAD_LETTER),
                            record, exc, self.path, metrics=rt.metrics)
                consumer.commit()
                if time.monotonic() >= next_hb:
                    if rt.faults is not None:
                        # chaos seam: a crashed heartbeat loop must
                        # restart under the supervisor and keep the
                        # worker alive (tests pin this)
                        await rt.faults.acheck("fleet.heartbeat")
                    await w.heartbeat()
                    next_hb = time.monotonic() + w.heartbeat_s
        finally:
            consumer.close()


class _WorkerApplyLoop(BackgroundTaskComponent):
    """Converge ownership whenever the placement view changes.

    Separate from the control loop on purpose: adopting a tenant can
    take seconds (engine start = jit warmup), and heartbeats must keep
    flowing through it or the controller would declare this worker dead
    mid-handoff."""

    def __init__(self, worker: FleetWorker):
        super().__init__("apply")
        self.worker = worker

    async def _run(self) -> None:
        w = self.worker
        # a supervised restart must re-converge even if no new record
        # arrives (the crash may have interrupted a half-applied epoch)
        w._dirty.set()
        while True:
            await w._dirty.wait()
            w._dirty.clear()
            await w.apply()
