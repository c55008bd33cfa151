"""Central registry of fault sites and metric names.

Fault sites and metric names ride the codebase as bare string literals
(the platform contract: a site is greppable, a metric name is the
dashboard's key). A typo — `"flow.admitt"`, a counter name registered
elsewhere as a gauge — used to fail only at dashboard-reading time.
This module is the single source of truth the static checkers (FLT01 /
MET01, `swx lint`) resolve every literal against, and the runtime
cross-check `FaultInjector.arm` consults in debug mode.

Generated from the current sites (regenerate the raw inventory with
`python -m sitewhere_tpu_torch.analysis --dump-registry` after adding a site
or metric, then fold the new names in here — the diff IS the review).

Adding a fault site: add the literal to `FAULT_SITES`, then consult it
via `faults.check(site)` / `await faults.acheck(site)`.
Adding a metric: add the base name (the part before any `:tenant`
suffix) under its kind below. A name may have exactly ONE kind — the
import-time check at the bottom fails the build on a conflict.
Adding a trace stage: add `(name, kind)` to `TRACE_STAGES` in pipeline
order (kind: "queue" = time spent waiting, "service" = time spent
working — the critical-path analyzer's split; "host" = host work that
belongs to no trace), then record it via `with tracer.span(name, ...)`
(or `tracer.record(trace_id, name, ...)` for a back-dated start); TRC01
resolves the literal here.
"""

from __future__ import annotations

# -- fault-injection sites (kernel/faults.py consults) ----------------------

FAULT_SITES = frozenset({
    "bus.produce",        # kernel/bus.py EventBus.produce
    "bus.poll",           # kernel/bus.py Consumer.poll_nowait
    "inbound.handle",     # services/inbound_processing.py per-record handle
    "fastlane.handle",    # kernel/fastlane.py fused per-record handle
    "egress.publish",     # kernel/egresslane.py per-batch scored publish
    "durable.flush",      # persistence/durable.py spill writer
    "scoring.dispatch",   # scoring/server.py flush paths
    "scoring.megabatch",  # scoring/pool.py megabatch admission
    "scoring.mesh",       # scoring/pool.py mesh-sharded dispatch admission
    "flow.admit",         # kernel/flow.py ingress admission
    "flow.shed",          # kernel/flow.py shed-mode consult
    "observe.beat",       # kernel/observe.py telemetry-beat sampler tick
    "fleet.heartbeat",    # fleet/worker.py heartbeat publish
    "fleet.rebalance",    # fleet/controller.py placement publish
    "fence.adopt",        # services/device_management.py replay-on-adopt
    "history.compact",    # history/store.py cold-tier compaction pass
    "history.replay",     # history/replay.py block admission into the pool
})

# -- trace stages (kernel/tracing.py spans; TRC01 resolves literals) ---------
# Pipeline order matters: the critical-path report renders in this order.
# kind "queue" = waiting (receiver arrival → decode start, admission →
# dispatch, deferred spool → replay), "service" = working. One name, one
# kind — a stage is either where events wait or where they are served.

TRACE_STAGES: tuple[tuple[str, str], ...] = (
    ("event-sources.receive", "queue"),      # arrival → decode start
    ("event-sources.decode", "service"),     # SWB1/JSON decode
    # wire-bus hop (kernel/wire.py): a split deployment's broker hop —
    # produce is the append RPC (service), poll is the broker-retention
    # wait between the append and the consuming worker's delivery
    # (queue). Recorded client-side on each side of the socket, so a
    # cross-process trace's queue-vs-service split covers the hop that
    # used to be dark (docs/OBSERVABILITY.md fleet observability).
    # Under streaming prefetch (the default), wire.poll measures broker
    # append → CREDIT DELIVERY (the deliver frame's arrival at the
    # consumer process), not the poll RPC round trip — prefetch-buffer
    # residency belongs to the consuming process's own stages.
    ("wire.produce", "service"),             # produce RPC → broker append
    ("wire.poll", "queue"),                  # broker append → delivery
    ("inbound.enrich", "service"),           # mask validate + split
    ("event-management.persist", "service"), # columnar store scatter
    ("rule-processing.dispatch", "queue"),   # admission → jit dispatch
    ("rule-processing.score", "service"),    # dispatch → scores on host
    ("egress.publish", "service"),           # settled → published
    ("flow.defer", "service"),               # overload spool publish
    ("flow.replay", "queue"),                # deferred drain re-admission
    ("dlq.quarantine", "service"),           # poison → dead-letter topic
    ("dlq.replay", "service"),               # dead letter → original topic
    # fleet observability plane (kernel/observe.py): the beat's export
    # publish onto the instance telemetry topic — its own trace family,
    # so the recorder's overhead is itself visible in the span rings
    ("fleet.telemetry", "service"),          # beat snapshot → telemetry topic
    # host stages: work of the process that belongs to no trace (one a
    # dispatch, one a collection). Recorded on every occurrence into
    # their own bounded rings, and a profiler range each while
    # torch.profiler runs; the critical-path split leaves them out.
    ("scoring.pool_take", "host"),           # pool: take every due tenant
    ("scoring.take_pending", "host"),        # session: take the admissions
    ("scoring.dispatch", "host"),            # pack + launch, no device wait
    ("scoring.update_and_score", "host"),    # session: one round's launch
    ("scoring.settle", "host"),              # results on host → delivered
    ("runtime.gc.full", "host"),             # a generation-2 collection
    ("runtime.gc.young", "host"),            # gen 0/1: a profiler range only
)

TRACE_STAGE_KINDS: dict[str, str] = dict(TRACE_STAGES)
if len(TRACE_STAGE_KINDS) != len(TRACE_STAGES):
    raise ValueError("duplicate trace stage in TRACE_STAGES")
HOST_STAGES = frozenset(name for name, kind in TRACE_STAGES
                        if kind == "host")


def trace_stage_kind(name: str) -> str | None:
    """Registered kind for a trace stage name, or None if unknown."""
    return TRACE_STAGE_KINDS.get(name)

# -- metric base names, by kind (kernel/metrics.py registry) ----------------
# Per-tenant variants use the `:{tenant_id}` suffix on the same base name
# and share the base's registration.

COUNTERS = (
    # scoring plane
    "scoring.anomalies_detected",
    "scoring.anomaly_overflow",
    "scoring.pool_flush_rounds",
    "scoring.admissions_dropped",
    "scoring.sink_failures",
    "scoring.bus_records_lost",
    "scoring.dispatches",
    "scoring.megabatch_dispatches",
    "scoring.stack_rebuilds",
    # pipeline services
    "inbound.events_unregistered",
    "fastlane.events_unregistered",
    "fastlane.records_lost",
    "egress.publish_failures",
    "egress.alert_failures",
    "rules.alerts_emitted",
    "batch.elements_processed",
    "event_sources.decode_failures",
    "event_sources.quota_rejected",
    "event_management.enrich_publish_failures",
    "device_state.presence_transitions",
    "schedule.jobs_fired",
    "command_delivery.delivered",
    "command_delivery.failed",
    "registration.devices_registered",
    "registration.requests_rejected",
    "registration.unknown_indices",
    "tenant_updates.malformed",
    # robustness subsystem
    "dlq.quarantined",
    "dlq.publish_failures",
    "dlq.replayed",
    "supervisor.restarts",
    # flow control (FlowController.count families)
    "flow.admitted",
    "flow.rejected",
    "flow.throttled",
    "flow.fair_granted",
    "flow.deferred_replayed",
    "flow.shed_reject",
    "flow.shed_degrade",
    "flow.shed_defer",
    # flight recorder (kernel/observe.py)
    "observe.beats",
    "observe.loop_stalls",
    # fleet control plane (sitewhere_tpu_torch/fleet)
    "fleet.heartbeats",
    "fleet.rebalances",
    "fleet.releases",
    "fleet.handoffs",
    "fleet.worker_deaths",
    "fleet.autoscale_up",
    "fleet.autoscale_down",
    # predictive control plane (fleet/forecast.py): forecast-attributed
    # scale decisions, confidence-gate demotions to pure-reactive, and
    # forecaster train/deploy rounds through the tenant-0 slot
    "fleet.forecast_decisions",
    "fleet.forecast_demotions",
    "fleet.forecast_trainings",
    # epoch fencing + replicated tenant state (docs/FLEET.md)
    "fence.rejections",   # stale-epoch data-path writes rejected
    "fence.replays",      # journal records replayed on adoption
    "fence.wal_appends",  # registry WAL appends (crash-bound tightener)
    # broker-side member eviction on death declarations (kernel/bus.py)
    "fleet.members_evicted",
    # self-tuning dispatch (mesh serving, docs/PERFORMANCE.md):
    # adaptive-megabatch-window and egress-lane tuner decisions
    "scoring.megabatch_window_adjusts",
    "egress.autotune_adjusts",
    # fleet observability plane (docs/OBSERVABILITY.md): beat snapshots
    # exported onto the instance telemetry topic, records the
    # FleetObserver folded, telemetry-history windows compacted to disk
    "observe.exports",
    "observe.fleet_records",
    "observe.history_windows",
    # wire data-plane fast path (kernel/wire.py): fire-and-forget ops
    # that rode a coalesced multi-op batch frame (per-tick pipelined
    # produce/commit — docs/PERFORMANCE.md wire fast path)
    "wire.frames_coalesced",
    # historical replay plane (sitewhere_tpu_torch/history): compaction passes
    # that folded ≥1 segment into cold-tier column blocks, and events
    # streamed from those blocks through the megabatch scoring path
    "history.compactions",
    "history.replay_events",
    # the process's garbage collections (kernel/tracing.py watch_gc):
    # per generation, `:gen0` / `:gen1` / `:gen2`
    "runtime.gc_collections",
)

GAUGES = (
    "flow.pressure",
    "flow.shed_level",
    # flight recorder (kernel/observe.py): per-group/tenant variants use
    # the `:{suffix}` convention on the same base names
    "observe.consumer_lag",
    "observe.egress_backlog",
    "observe.scoring_pending",
    "observe.scoring_inflight",
    # fleet control plane (sitewhere_tpu_torch/fleet)
    "fleet.workers_live",
    "fleet.placement_epoch",
    "fleet.tenants_pending",
    # predictive control plane (fleet/forecast.py): relative horizon
    # error EMA (the confidence gate's accuracy signal), the deployed
    # forecaster checkpoint version, and the live fleet-wide predicted
    # load at the horizon
    "fleet.forecast_horizon_error_ema",
    "fleet.forecast_model_version",
    "fleet.forecast_load_predicted",
    # mesh-sharded serving + self-tuning dispatch (scoring/pool.py,
    # kernel/egresslane.py): devices under the stacked dispatch, the
    # live adaptive megabatch window, active egress lanes
    "scoring.mesh_devices",
    "scoring.megabatch_window_ms",
    "egress.autotune_lanes",
    # per-device mesh telemetry (scoring/pool.py mesh_stats): tenant-row
    # occupancy of the stacked dispatch and the LIVE per-device model
    # throughput — the "read it on a real rig" surface, per-pool
    # `:{model}` suffix like scoring.mesh_devices
    "scoring.mesh_row_occupancy",
    "scoring.model_tflops_per_device",
    # fleet observability plane (fleet/observer.py): workers with a
    # live beat on the telemetry topic, observer's own topic lag
    "observe.fleet_workers",
    "observe.telemetry_lag",
    # wire data-plane fast path (kernel/wire.py RemoteEventBus): the
    # live credit window (0 = prefetch off) and the op count of the
    # most recent coalesced batch frame
    "wire.prefetch_credit",
    "wire.linger_batches",
    # historical replay plane (sitewhere_tpu_torch/history): events/s of the
    # most recent replay run, and the max per-tenant score divergence
    # from the most recent shadow-scoring comparison
    "history.replay_rate",
    "history.divergence_max",
)

METERS = (
    "scoring.events_scored",
    "inbound.events_processed",
    "fastlane.events_processed",
    "egress.events_published",
    "event_sources.events_received",
    "event_management.events_persisted",
    "device_state.events_merged",
    "outbound.records_forwarded",
)

HISTOGRAMS = (
    "scoring.e2e_latency_s",
    "scoring.batch_latency_s",
    "scoring.batch_size",
    "scoring.stage_admit_s",
    "scoring.stage_batch_s",
    "scoring.stage_device_s",
    "scoring.stage_sink_s",
    "scoring.megabatch_tenants_per_dispatch",
    # flight recorder (kernel/observe.py): event-loop lag per beat
    "observe.loop_lag_s",
    # fleet: placement-seen → engines-adopted per tenant move
    "fleet.handoff_s",
    # the loop's pause in each garbage collection, every generation
    "runtime.gc_pause_s",
)

# f-string metric names whose suffix is computed at runtime
# (FlowController.count builds f"flow.{name}"); MET01 accepts an
# f-string whose literal prefix matches one of these exactly.
DYNAMIC_METRIC_PREFIXES = ("flow.",)

# name -> kind; built with a conflict check so a metric registered under
# two kinds fails at import (and therefore fails the build / meta-test).
METRICS: dict[str, str] = {}
for _kind, _names in (("counter", COUNTERS), ("gauge", GAUGES),
                      ("meter", METERS), ("histogram", HISTOGRAMS)):
    for _name in _names:
        if _name in METRICS:
            raise ValueError(
                f"metric {_name!r} registered as both {METRICS[_name]} "
                f"and {_kind} — one name, one kind")
        METRICS[_name] = _kind
del _kind, _names, _name


def metric_kind(base_name: str) -> str | None:
    """Registered kind for a metric base name, or None if unknown."""
    return METRICS.get(base_name)


def is_fault_site(site: str) -> bool:
    return site in FAULT_SITES
