"""Fleet observer: fold per-worker telemetry beats into ONE fleet view.

The flight recorder instruments one runtime; the fleet split left
`swx top` / `observe_report()` able to see only the process
they run in. This component closes that: every worker's `TelemetryBeat`
exports its sample (+ mergeable per-stage span summaries) onto the
bounded `<instance>.instance.telemetry` topic (kernel/observe.py), and
the `FleetObserver` — a child of the `FleetController`, so it runs on
the broker host — folds the stream into:

- a **fleet critical path**: per-stage bucket histograms merged across
  workers (`kernel/tracing.py merge_stage_exports` — per-worker p99s
  cannot be averaged; bucket-wise merge keeps fleet quantiles exact to
  bucket resolution), including the local ingress host's own
  receive/decode and the `wire.produce`/`wire.poll` broker-hop spans,
  so queue-vs-service attribution spans process boundaries;
- a **per-worker / per-tenant lag matrix**: broker-central
  `group_lags()` joined with the controller's owner map;
- **mesh-dispatch occupancy**: each worker's `scoring.pool mesh_stats`
  blocks (axis shape, tenant-row occupancy, live per-device tflops);
- the **broker's own stats** (`EventBus.stats()`): per-topic depth,
  per-group lag/membership, fence rejections, members evicted — the
  "broker is a black box" closer.

On start the observer's consumer seeks to the topic's beginning: a
restarted controller host REPLAYS the retained telemetry stream and
rebuilds every worker's last-known state before the first fresh beat
arrives (test-pinned). When the runtime has a durable telemetry
history (`runtime.history`), each tick appends the broker-central
per-tenant lag series and each worker's loop lag — the fleet-level
training substrate ROADMAP item 2 names.

Surfaces: `GET /api/fleet/observe` (rest/api.py), the fleet-merged
Prometheus exposition at `GET /api/fleet/metrics/prometheus`, and
`swx top --fleet` (cli.py render_fleet_top).
"""

from __future__ import annotations

import itertools
import logging
import os
import time
from typing import Optional

from sitewhere_tpu_torch.kernel import dlq
from sitewhere_tpu_torch.kernel.bus import TopicNaming
from sitewhere_tpu_torch.kernel.lifecycle import (
    BackgroundTaskComponent,
    LifecycleComponent,
)
from sitewhere_tpu_torch.kernel.observe import per_tenant_lags
from sitewhere_tpu_torch.kernel.tracing import merge_stage_exports

logger = logging.getLogger(__name__)

# a worker whose last beat is older than this is dropped from the view
# (it left, died, or stopped exporting); the fleet controller's
# liveness is authoritative — this bound only keeps the OBSERVER's map
# from growing stale entries forever
_STALE_AFTER_S = 60.0

_observer_ids = itertools.count(1)


class FleetObserver(LifecycleComponent):
    """The fleet-wide flight recorder (child of the broker-host
    runtime, created by the FleetController; standalone in tests)."""

    def __init__(self, runtime, *, poll_timeout_s: float = 0.25,
                 history_interval_s: float = 1.0):
        super().__init__("fleet-observer")
        self.runtime = runtime
        self.poll_timeout_s = poll_timeout_s
        # broker-central work (a group_lags sweep + history appends) is
        # rate-limited to this cadence: the observer shares its host
        # with the controller AND the ingress edge — a sweep per poll
        # round was measurable at fleet saturation on the 1-core rig
        self.history_interval_s = history_interval_s
        self._last_history_t = 0.0
        self.topic = runtime.naming.instance_topic(
            TopicNaming.INSTANCE_TELEMETRY)
        # broadcast semantics: every observer instance consumes the
        # WHOLE topic under its own group (like each fleet worker's
        # control consumer) — two observers sharing one group would
        # split partitions and each see only some workers' beats.
        # A fresh group + seek-to-beginning also makes restart replay
        # unconditional (no stale committed offsets to fight).
        self.group = (f"fleet.observer.{runtime.settings.instance_id}"
                      f".{os.getpid()}-{next(_observer_ids)}")
        # wid -> {"seq", "t", "received_at", "sample", "beat", "stages"}
        self.workers: dict[str, dict] = {}
        metrics = runtime.metrics
        self.records = metrics.counter("observe.fleet_records")
        self.workers_gauge = metrics.gauge("observe.fleet_workers")
        self.lag_gauge = metrics.gauge("observe.telemetry_lag")
        self._loop = _ObserverLoop(self)
        self.add_child(self._loop)
        runtime.fleet_observer = self

    # -- record folding ------------------------------------------------------

    def handle(self, value) -> None:
        """Fold one telemetry record. Per-worker streams are keyed by
        worker id (partition-ordered), so the latest record per worker
        wins; `stages` rides only every Nth beat and is retained from
        the last record that carried it."""
        if not isinstance(value, dict):
            raise ValueError(f"not a telemetry record: {value!r}")
        if value.get("kind") != "beat":
            return  # forward-compatible: unknown kinds are no-ops
        wid = value["worker"]
        state = self.workers.setdefault(wid, {})
        state["seq"] = int(value.get("seq", 0))
        t_beat = float(value.get("t", 0.0))
        state["t"] = t_beat
        # age anchored to the BEAT's wall time, not fold time: topic
        # REPLAY after a controller restart must not resurrect a
        # long-dead worker with beat_age_s≈0 — its replayed records
        # fold with their true age and prune immediately if stale
        age = max(time.time() - t_beat, 0.0) if t_beat else 0.0
        state["received_at"] = time.monotonic() - age
        state["sample"] = value.get("sample") or {}
        state["beat"] = value.get("beat") or {}
        stages = value.get("stages")
        if stages is not None:
            state["stages"] = stages
        self.records.inc()

    def _local_key(self) -> str:
        """The host runtime's identity on the telemetry topic (mirrors
        TelemetryBeat._worker_key): its beats appear in `workers` like
        any peer's, but its STAGES merge live, never from the topic."""
        fence = getattr(self.runtime, "fence", None)
        return getattr(fence, "worker_id", None) \
            or self.runtime.settings.instance_id

    def _prune(self) -> None:
        now = time.monotonic()
        for wid in [w for w, s in self.workers.items()
                    if now - s.get("received_at", now) > _STALE_AFTER_S]:
            self.workers.pop(wid, None)
            logger.info("fleet-observer: dropped stale worker %s "
                        "(no beat for %.0fs)", wid, _STALE_AFTER_S)
        self.workers_gauge.set(len(self.workers))

    # -- central signals (broker-host only) ----------------------------------

    def _broker_lags(self) -> dict[str, dict[str, int]]:
        """Broker-central group lags when the bus is local (the
        controller host owns the in-proc bus the BusServer serves);
        empty on a wire-bus observer (nothing central to read)."""
        group_lags = getattr(self.runtime.bus, "group_lags", None)
        if group_lags is None:
            return {}
        try:
            # event-weighted: the fleet lag matrix and the durable lag
            # series feed autoscaling — queue depth in events (see
            # EventBus.group_lags)
            lags = group_lags(events=True)
        except TypeError:  # wire-proxied bus: record units only
            lags = group_lags()
        if not isinstance(lags, dict):
            # wire bus: the broker owns this signal — a wire-attached
            # observer reports beats only (close the stray coroutine)
            close = getattr(lags, "close", None)
            if callable(close):
                close()
            return {}
        return lags

    def tenant_lags(self, lags: Optional[dict] = None) -> dict[str, int]:
        if lags is None:
            lags = self._broker_lags()
        # roster-filtered like FleetController.tenant_lags: dotted
        # non-tenant groups must not become phantom lag-matrix rows
        fleet = getattr(self.runtime, "fleet", None)
        roster = (getattr(fleet, "tenants", None)
                  or getattr(self.runtime, "tenants", None) or None)
        return per_tenant_lags(lags, roster=roster)

    def append_history(self) -> None:
        """One tick's fleet-level series into the durable history
        (when the host runtime has one): each worker's loop lag, folded
        from the telemetry beats. The per-tenant `lag` series is
        written by the host's OWN TelemetryBeat (same store, same
        broker-central group_lags — a second writer here would mix two
        sampling cadences into one window's statistics), and the
        per-WORKER series (egress backlog, scoring occupancy) persist
        worker-side. Rate-limited to `history_interval_s`."""
        history = getattr(self.runtime, "history", None)
        if history is None:
            return
        now = time.monotonic()
        if now - self._last_history_t < self.history_interval_s:
            return
        self._last_history_t = now
        t = time.time()
        for wid, state in self.workers.items():
            sample = state.get("sample") or {}
            history.append(wid, "loop_lag_ms",
                           float(sample.get("loop_lag_ms", 0.0)), t=t)

    # -- the fleet-wide report ----------------------------------------------

    def snapshot(self) -> dict:
        """The fleet observe report (`GET /api/fleet/observe`,
        `swx top --fleet`, bench `fleet_observe` block)."""
        self._prune()
        now = time.monotonic()
        lags = self._broker_lags()
        fleet = getattr(self.runtime, "fleet", None)
        owners = dict(getattr(fleet, "owners", None) or {})
        workers: dict[str, dict] = {}
        exports: list[dict] = []
        for wid, state in sorted(self.workers.items()):
            sample = state.get("sample") or {}
            beat = state.get("beat") or {}
            scoring = sample.get("scoring") or {}
            workers[wid] = {
                "beat_age_s": round(now - state.get("received_at", now), 3),
                "seq": state.get("seq", 0),
                "beats": beat.get("beats", 0),
                "loop_lag_ms": sample.get("loop_lag_ms", 0.0),
                "loop_lag_p99_ms": beat.get("loop_lag_p99_ms", 0.0),
                "loop_stalls": beat.get("loop_stalls", 0),
                "consumer_lag_max": sample.get("consumer_lag_max", 0),
                "egress_backlog": sum(
                    (sample.get("egress_backlog") or {}).values()),
                "scoring_pending": sum(
                    s.get("pending", 0) for s in scoring.values()),
                "scoring_inflight": sum(
                    s.get("inflight", 0) for s in scoring.values()),
                "flow_modes": {tid: (m or {}).get("mode", "ok")
                               for tid, m
                               in (sample.get("flow") or {}).items()},
                "mesh": sample.get("mesh") or [],
            }
            if state.get("stages") and wid != self._local_key():
                # the local runtime's stages merge LIVE below; folding
                # its retained export too would double-count every
                # local span when the controller host itself exports
                exports.append(state["stages"])
        # the local process's stages join the merge: on the controller
        # host that's the ingress half (receive/decode) plus its side
        # of the wire hop — without it the fleet path starts mid-air
        exports.append(self.runtime.tracer.stage_export())
        critical_path = merge_stage_exports(exports)
        critical_path["workers_merged"] = len(exports)
        # per-worker/per-tenant lag matrix: broker group lags attributed
        # to the owner the controller last confirmed
        lag_matrix: dict[str, dict] = {}
        for tid, lag in self.tenant_lags(lags).items():
            lag_matrix[tid] = {"lag": lag, "worker": owners.get(tid)}
        # the observer's own lag on the telemetry topic: a growing
        # number here means the fleet view is FALLING BEHIND the fleet
        own_lag = sum((lags.get(self.group) or {}).values())
        self.lag_gauge.set(own_lag)
        stats_fn = getattr(self.runtime.bus, "stats", None)
        broker = stats_fn() if callable(stats_fn) else None
        if broker is not None and not isinstance(broker, dict):
            broker = None  # wire bus: stats is an awaitable — central only
        history = getattr(self.runtime, "history", None)
        mesh = {wid: w["mesh"] for wid, w in workers.items() if w["mesh"]}
        return {
            "workers": workers,
            "critical_path": critical_path,
            "lag_matrix": dict(sorted(lag_matrix.items())),
            "mesh": mesh,
            "telemetry": {
                "topic": self.topic,
                "records": int(self.records.value),
                "observer_lag": own_lag,
            },
            "broker": broker,
            "history": history.stats() if history is not None else None,
        }

    def prometheus_text(self) -> str:
        """Fleet-merged Prometheus exposition: per-worker/per-tenant
        labeled gauges beside the merged critical-path quantiles —
        scrape ONE endpoint on the controller host instead of N
        workers (each worker's own `/api/instance/metrics/prometheus`
        stays the per-process deep view)."""
        snap = self.snapshot()
        lines: list[str] = []

        def gauge(name: str, labels: dict, value) -> None:
            lbl = ",".join(f'{k}="{v}"' for k, v in labels.items())
            lines.append(f"swx_fleet_{name}{{{lbl}}} {value}")

        for metric in ("worker_loop_lag_ms", "worker_consumer_lag",
                       "worker_egress_backlog", "worker_scoring_pending",
                       "worker_loop_stalls", "tenant_lag",
                       "stage_p99_ms", "mesh_tflops_per_device",
                       "mesh_row_occupancy"):
            lines.append(f"# TYPE swx_fleet_{metric} gauge")
        for wid, w in snap["workers"].items():
            gauge("worker_loop_lag_ms", {"worker": wid}, w["loop_lag_ms"])
            gauge("worker_consumer_lag", {"worker": wid},
                  w["consumer_lag_max"])
            gauge("worker_egress_backlog", {"worker": wid},
                  w["egress_backlog"])
            gauge("worker_scoring_pending", {"worker": wid},
                  w["scoring_pending"])
            gauge("worker_loop_stalls", {"worker": wid}, w["loop_stalls"])
            for block in w["mesh"]:
                labels = {"worker": wid,
                          "model": block.get("model", "?")}
                gauge("mesh_tflops_per_device", labels,
                      block.get("model_tflops_per_device", 0.0))
                gauge("mesh_row_occupancy", labels,
                      block.get("row_occupancy", 0.0))
        for tid, row in snap["lag_matrix"].items():
            gauge("tenant_lag",
                  {"tenant": tid, "worker": row.get("worker") or ""},
                  row["lag"])
        for stage, row in snap["critical_path"]["stages"].items():
            gauge("stage_p99_ms",
                  {"stage": stage, "kind": row.get("kind", "unknown")},
                  row["p99_ms"])
        return "\n".join(lines) + "\n"


class _ObserverLoop(BackgroundTaskComponent):
    """Consume the telemetry topic (one supervised loop)."""

    def __init__(self, observer: FleetObserver):
        super().__init__("loop")
        self.observer = observer

    async def _run(self) -> None:
        obs = self.observer
        rt = obs.runtime
        consumer = rt.bus.subscribe(obs.topic, group=obs.group,
                                    name="fleet.observer")
        # replay the retained stream first: a restarted broker host
        # rebuilds every worker's last-known beat (and its last stage
        # export) before the next fresh beat arrives
        consumer.seek_to_beginning()
        try:
            while True:
                records = await consumer.poll(timeout=obs.poll_timeout_s)
                for record in records:
                    try:
                        obs.handle(record.value)
                    except Exception as exc:  # noqa: BLE001 - poison isolated
                        await dlq.quarantine(
                            rt.bus,
                            rt.naming.instance_topic(TopicNaming.DEAD_LETTER),
                            record, exc, self.path, metrics=rt.metrics)
                consumer.commit()
                obs._prune()
                obs.append_history()
        finally:
            consumer.close()
