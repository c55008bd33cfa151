"""The port's bench entry: every mode of `bench.py` on the port.

    python -m sitewhere_tpu_torch.tools.bench [bench.py's flags] [--cpu]
    python -m sitewhere_tpu_torch.cli bench [the same flags]

Prints one JSON line last, with the top-level keys of `bench.py`'s
report for the same flags; the values are the port's own. The modes, in
`bench.py`'s order of precedence:

- `--train` (`bench.py:1834-1878`): ETL windows/s and train steps/s;
- `--gnn` (`:1745-1833`): the maintenance graph's build and GNN risk
  scores/s at `GNN_SIZES` devices;
- `--replay` (`:2103-2272`) over `tools/replay_bench.py`;
- `--split` (`:444-616`) over `tools/split.py`;
- `--ramp` (`:1243-1744`) over `tools/fleet.py` with the live autoscaler
  and the predictive planner (`--no-forecast`: reactive only);
- `--workers N` (`:617-1242`) over `tools/fleet.py`, with the kill drill
  and `--zombie-drill`;
- `--overload` (`:1879-2088`) over the port's `kernel/flow.py`;
- the default run (`:2273-2800`) over `tools/pipeline.py`: saturation
  trials (best and median), the paced window at `--paced-fraction`, the
  stage breakdown, MFU, and the levers (`--tenants`/`--pooled`,
  `--megabatch`, `--no-fastlane`, `--no-egress-fusion`/`--egress-lanes`,
  `--no-observe`, `--durable`, `--chaos`).

Differences from `bench.py`, each deliberate:

- no supervisor, no probe subprocess and no CPU fallback: the entry runs
  on the CUDA card, and on the CPU only when `--cpu` is given (`bench.py`'s
  `--force-cpu`). A host without a card fails at start (`utils/device.py`).
  The caller shapes a CPU run (`--devices`, `--paced-fraction`): there is
  no `_cpu_shape_fleet`;
- on any failure the entry prints `bench.py`'s error artifact and exits 1;
- `pallas` holds K1's status on the run's first sink: `"cuda"` when a
  dedicated windowed session launches the window kernel on the card,
  `"plain"` for its plain version on the CPU, null when no K1 runs. The
  launches and dispatches over the measured phases go to stderr as one
  `[bench] kernels {...}` line;
- `lint` is `bench.py`'s `_lint_summary` over this package (the port's
  swxlint, `analysis/`);
- `mfu` is the achieved model FLOP/s over one card's dense bf16 peak
  (`PEAK_BF16_FLOPS`, matched on the card's name); an unknown kind gives
  null;
- `--mesh DxM` shards the megabatch pool over a `{data: D, model: M}`
  mesh fitted to the devices there are (every card; with `--cpu`, D×M
  logical CPU devices, as `bench.py` forces D×M host devices): on one
  card it degrades to meshless with the reference's warning, and
  `scoring.mesh` reports what ran (`shape` null, `devices` 0);
- `--profile DIR` writes a `torch.profiler` trace of phase 1
  (`DIR/trace.json`).
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import os
import shutil
import statistics
import sys
import tempfile
import time
import traceback
from typing import Optional

import numpy as np


# dense bf16 tensor peak by card name (lowercased substring; NVIDIA's
# data sheet for the H100 SXM); an unknown kind (the CPU too) reports
# no MFU rather than a made-up one
PEAK_BF16_FLOPS = (
    ("h100 80gb hbm3", 989e12),
)
# the GNN bench's fleet sizes (`bench.py:1776`)
GNN_SIZES = (1000, 10000)
logger = logging.getLogger(__name__)


def lint_summary() -> dict:
    """`bench.py`'s `_lint_summary` over this package: new/baselined
    swxlint finding counts, per code, and each checker's wall time.
    Never fails the bench."""
    try:
        from sitewhere_tpu_torch.analysis import lint_package

        report = lint_package()
        per_code: dict = {}
        for f in report.findings:
            per_code.setdefault(f.code, {"new": 0, "baselined": 0})
            per_code[f.code]["new"] += 1
        for f, _reason in report.baselined:
            per_code.setdefault(f.code, {"new": 0, "baselined": 0})
            per_code[f.code]["baselined"] += 1
        return {"new": len(report.findings),
                "baselined": len(report.baselined),
                "suppressed": len(report.suppressed),
                "by_code": per_code,
                "timings_s": {c: round(t, 4)
                              for c, t in sorted(report.timings.items())}}
    except Exception as exc:  # noqa: BLE001 - the artifact must still parse
        return {"error": f"{type(exc).__name__}: {exc}"}


def error_artifact(args, msg: str) -> str:
    """`bench.py`'s `_error_artifact` (`:195-207`)."""
    return json.dumps({
        "metric": ("train_windows_per_sec" if args.train
                   else "replay_events_per_sec" if args.replay
                   else "pipeline_scored_events_per_sec"),
        "value": 0.0,
        "unit": "windows/s" if args.train else "events/s",
        "vs_baseline": 0.0,
        "error": msg,
        "model": args.model, "fleet_devices": args.devices,
    })


def device_arg(args) -> Optional[str]:
    return "cpu" if args.cpu else None


def probe(args) -> tuple[str, str, int]:
    """(platform, device_kind, chips) of the device the run targets, after
    one small product on it. No card and no `--cpu` raises here."""
    import torch

    from sitewhere_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device_arg(args))
    x = torch.ones((8, 8), device=dev)
    float((x @ x).sum())
    if dev.type == "cuda":
        return "gpu", torch.cuda.get_device_name(dev), \
            torch.cuda.device_count()
    return "cpu", "cpu", 1


def peak_flops(device_kind: str) -> Optional[float]:
    kind = device_kind.lower()
    return next((v for k, v in PEAK_BF16_FLOPS if k in kind), None)


def k1_status(sink) -> Optional[str]:
    """`pallas`: does this sink's ring take K1 (a dedicated session on a
    window ring whose model's `score_fused` takes the kernel)?"""
    from sitewhere_tpu_torch.scoring.ring import DeviceRing

    ring = getattr(sink, "ring", None)
    model = getattr(sink, "model", None)
    if isinstance(ring, DeviceRing) and getattr(model, "fused", False):
        return "cuda" if ring.device.type == "cuda" else "plain"
    return None


def log_kernels(launches: int, dispatches: int, status) -> None:
    """The K1 record of a run, one line on stderr."""
    print("[bench] kernels " + json.dumps({"lstm_window_final": {
        "launches": int(launches), "dispatches": int(dispatches),
        "pallas": status}}), file=sys.stderr, flush=True)


def wipe_durable(path: str, force: bool) -> None:
    """A fresh durable dir a run (`bench.py:2302-2318`): never silently
    destroy a directory this run did not create."""
    if os.path.isdir(path) and os.listdir(path) and not force:
        raise RuntimeError(
            f"--durable {path!r} exists and is not empty; the bench wipes "
            "its durable dir before each run — pass --force-wipe to "
            "confirm, or point it somewhere fresh")
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path, exist_ok=True)


def breakdown_of(hists: dict) -> dict:
    return {nm: {"p50_ms": round(h.quantile(0.5) * 1e3, 3),
                 "p95_ms": round(h.quantile(0.95) * 1e3, 3),
                 "p99_ms": round(h.quantile(0.99) * 1e3, 3)}
            for nm, h in hists.items() if h is not None}


# -- the default run ----------------------------------------------------------

async def run_default(args) -> dict:
    """`bench.py`'s `run_bench` (`:2273-2800`) on `tools/pipeline.py`."""
    from sitewhere_tpu_torch.tools import pipeline as pl

    platform, device_kind, n_chips = probe(args)
    if args.durable:
        wipe_durable(args.durable, args.force_wipe)
    chaos = {}
    if args.chaos:
        # faults at three layers, bounded a site so the restart budget
        # (5 in 60 s) is never exceeded by design: consumer polls, the
        # scoring dispatch, the durable spill writer
        chaos = {"bus.poll": (0.002, args.chaos_faults),
                 "scoring.dispatch": (0.01, args.chaos_faults)}
        if args.durable:
            chaos["durable.flush"] = (0.05, args.chaos_faults)
    dep = pl.Deployment(
        model=args.model, devices=args.devices, tenants=args.tenants,
        pooled=args.pooled, megabatch=args.megabatch, window=args.window,
        window_ms=args.window_ms, max_inflight=args.max_inflight,
        history=args.history, readback=args.readback,
        egress_fused=not args.no_egress_fusion,
        egress_lanes=args.egress_lanes, egress_autotune=args.egress_autotune,
        fastlane=not args.no_fastlane, observe=not args.no_observe,
        data_dir=args.durable, device=device_arg(args),
        trace_sample=64, ready_timeout_s=args.ready_timeout,
        anomaly_rate=0.001, chaos=chaos, chaos_seed=args.chaos_seed,
        mesh=args.mesh_spec,
        # a CPU run gets the D×M logical devices the spec asks for
        cpu_mesh_devices=(args.mesh_spec["data"] * args.mesh_spec["model"]
                          if args.mesh_spec else 1))
    pipes = await pl.deploy(dep)
    try:
        return await _default_phases(args, dep, pipes, platform,
                                     device_kind, n_chips)
    finally:
        await pipes[0].rt.stop()


async def _default_phases(args, dep, pipes, platform, device_kind,
                          n_chips) -> dict:
    """The default run's phases on a deployed pipeline: the warm pass,
    the saturation trials, the paced window, and the report."""
    from sitewhere_tpu_torch.kernel.observe import observe_report
    from sitewhere_tpu_torch.ops import lstm_kernel

    rt = pipes[0].rt
    tenant_ids = dep.tenant_ids
    per_tenant = max(args.devices // len(tenant_ids), 1)
    sims = [p.sim for p in pipes]
    receivers = [p.receiver for p in pipes]
    sinks = [p.sink for p in pipes]
    engines = [p.engine for p in pipes]
    megabatch_on = all(e.megabatch and e.pool_slot is not None
                       for e in engines)
    pool0 = (engines[0].pool_slot.pool
             if engines[0].pool_slot is not None else None)
    eff_window_ms = (pool0.cfg.window_s * 1e3 if pool0 is not None
                     else args.window_ms)
    # mesh provenance from the LIVE pool (mesh_from_spec may have fitted
    # the request down to this process's devices)
    mesh = pool0.mesh if pool0 is not None else None
    mesh_devices = mesh.size if mesh is not None else 0
    mesh_shape = dict(mesh.shape) if mesh is not None else None
    disp_counter = rt.metrics.counter("scoring.dispatches")
    fastlane_on = all(getattr(e, "fastlane", None) is not None
                      for e in engines)
    egress_on = all(getattr(e, "egress", None) is not None for e in engines)
    egress_lanes_live = max(args.egress_lanes, 1)
    if egress_on:
        egress_lanes_live = max(e.egress.lanes for e in engines)
    session = sinks[0]
    t_base = pipes[0].t

    # a warm pass through the whole pipeline
    for k in range(3):
        for sim, receiver in zip(sims, receivers):
            await receiver.submit(sim.payload(t=t_base + k)[0])
    await asyncio.sleep(0.5)

    lat_hist = session.latency  # pooled: one shared histogram
    lat_hist.reset()

    def inflight_total():
        return sum(s.inflight for s in sinks)

    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if platform == "gpu":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    # K1's launches and the dispatches over the measured phases
    lstm_kernel.launches = 0
    d_measured = disp_counter.value
    trials = []
    k = 0
    for trial in range(max(args.sat_trials, 1)):
        if trial > 0:
            # quiesce: a previous trial's late settles must not land in
            # this trial's window (idle = nothing in flight, no new
            # scores for a beat), bounded
            q_deadline = time.monotonic() + args.drain_timeout
            last_count, idle_since = lat_hist.count, time.monotonic()
            while time.monotonic() < q_deadline:
                await asyncio.sleep(0.1)
                if inflight_total() > 0 or lat_hist.count != last_count:
                    last_count = lat_hist.count
                    idle_since = time.monotonic()
                elif time.monotonic() - idle_since > 1.0:
                    break
        lat_hist.reset()
        d0 = disp_counter.value
        t0 = time.monotonic()
        sent = 0
        while time.monotonic() - t0 < args.seconds:
            for sim, receiver in zip(sims, receivers):
                payload, _ = sim.payload(t=t_base + 10 + 0.001 * k)
                # only ACCEPTED events count: a shed payload never
                # enters the pipeline
                if await receiver.submit(payload):
                    sent += per_tenant
            k += 1
        t_drain = time.monotonic()
        deadline = t_drain + args.drain_timeout
        while ((lat_hist.count < sent or inflight_total() > 0)
               and time.monotonic() < deadline):
            await asyncio.sleep(0.05)
        drain_s = time.monotonic() - t_drain
        drain_ok = lat_hist.count >= sent and inflight_total() == 0
        t_elapsed = time.monotonic() - t0
        n_disp = int(disp_counter.value - d0)
        trials.append({
            "rate": round(lat_hist.count / t_elapsed, 1) if t_elapsed else 0.0,
            "events_scored": int(lat_hist.count),
            "seconds": round(t_elapsed, 2),
            "dispatches": n_disp,
            "dispatch_rate": (round(n_disp / t_elapsed, 1) if t_elapsed
                              else 0.0),
            "drain_complete": drain_ok,
            "drain_seconds": round(drain_s, 2),
        })
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    # best clean-drain trial wins; if none drained, the best overall
    clean = [t for t in trials if t["drain_complete"]] or trials
    best = max(clean, key=lambda t: t["rate"])
    rate_median = statistics.median(t["rate"] for t in clean)
    rate = best["rate"]
    scored = best["events_scored"]

    # phase 2: latency at a paced offered load (no queue build-up)
    paced_rate = args.paced_fraction * rate
    interval = len(tenant_ids) * per_tenant / max(paced_rate, 1.0)
    lat_hist.reset()
    stages = {nm: getattr(session, f"stage_{nm}", None)
              for nm in ("admit", "batch", "device", "sink")}
    for h in stages.values():
        if h is not None:
            h.reset()  # the breakdown describes the paced window only
    t1 = time.monotonic()
    paced_sent = 0
    next_t = t1
    while time.monotonic() - t1 < args.latency_seconds:
        for sim, receiver in zip(sims, receivers):
            payload, _ = sim.payload(t=t_base + 10_000 + 0.001 * paced_sent)
            if await receiver.submit(payload):
                paced_sent += per_tenant
        next_t += interval
        delay = next_t - time.monotonic()
        if delay > 0:
            await asyncio.sleep(delay)
    t_drain = time.monotonic()
    deadline = t_drain + args.latency_drain_timeout
    while ((lat_hist.count < paced_sent or inflight_total() > 0)
           and time.monotonic() < deadline):
        await asyncio.sleep(0.05)
    lat_drain_s = time.monotonic() - t_drain
    lat_drain_ok = lat_hist.count >= paced_sent and inflight_total() == 0
    status = k1_status(session)
    log_kernels(lstm_kernel.launches, disp_counter.value - d_measured, status)

    if args.debug_stages:
        import pprint

        print("--- stage summary (sampled spans) ---", file=sys.stderr)
        pprint.pprint(rt.tracer.stage_summary(), stream=sys.stderr)

    p99 = lat_hist.quantile(0.99)
    p50 = lat_hist.quantile(0.50)
    breakdown = breakdown_of(stages)

    # MFU: achieved model FLOP/s at the saturation rate over one card's
    # peak
    model_obj = getattr(session, "model", None) or session.pool.model
    flops_ev = float(getattr(model_obj, "flops_per_event", lambda: 0.0)())
    model_flops_s = rate * flops_ev
    peak = peak_flops(device_kind)
    mfu = model_flops_s / peak if peak else None
    model_tflops_median = rate_median * flops_ev / 1e12

    spill = None
    if args.durable:
        logs = [rt.api("event-management").management(t).durable
                for t in tenant_ids]
        spill = {"written": sum(d.written for d in logs if d),
                 "dropped": sum(d.dropped for d in logs if d)}

    observe = None
    if rt.beat is not None:
        rep = observe_report(rt)
        beat_snap = rep["beat"] or {}
        cp = rep["critical_path"]
        observe = {
            "beats": beat_snap.get("beats", 0),
            "consumer_lag_max": beat_snap.get("consumer_lag_max", 0),
            "loop_lag_p99_ms": beat_snap.get("loop_lag_ms", {}).get(
                "p99", 0.0),
            "loop_lag_max_ms": beat_snap.get("loop_lag_ms", {}).get(
                "max", 0.0),
            "loop_stalls": beat_snap.get("loop_stalls", 0),
            "queue_wait_p99_ms": cp["queue_wait_p99_ms"],
            "service_p99_ms": cp["service_p99_ms"],
            "critical_path": cp["stages"],
        }

    egress_active = (max(e.egress.active for e in engines)
                     if egress_on else 0)
    chaos = None
    if rt.faults is not None:
        chaos = {"seed": args.chaos_seed, "sites": rt.faults.snapshot(),
                 "supervisor_restarts": int(rt.metrics.counter(
                     "supervisor.restarts").value),
                 "dead_letters": int(rt.metrics.counter(
                     "dlq.quarantined").value)}
    sparse = (getattr(getattr(session, "ring", None), "sparse_threshold",
                      None) is not None
              or getattr(getattr(getattr(session, "pool", None), "ring",
                                 None), "sparse", False))
    return {
        "metric": "pipeline_scored_events_per_sec",
        "value": round(rate, 1),
        "unit": "events/s",
        "value_median": round(rate_median, 1),
        "vs_baseline": round(rate / 1_000_000, 4),
        "vs_baseline_median": round(rate_median / 1_000_000, 4),
        "p99_ms": round(p99 * 1e3, 3),
        "p50_ms": round(p50 * 1e3, 3),
        "p99_breakdown": breakdown,
        "pipeline_owned_p99_ms": round(
            sum(breakdown[k]["p99_ms"]
                for k in ("admit", "batch", "sink") if k in breakdown), 3),
        "paced_rate": round(paced_rate, 1),
        "fastlane": "on" if fastlane_on else "off",
        "hops": 1 if fastlane_on else 3,
        "egress": {"fused": egress_on, "lanes": egress_lanes_live,
                   "autotune": bool(args.egress_autotune),
                   "active_lanes": egress_active,
                   "autotune_adjusts": int(rt.metrics.counter(
                       "egress.autotune_adjusts").value)},
        "scoring": {
            "megabatch": megabatch_on,
            # serving mesh: requested spec + what actually ran (0
            # devices = single-device stacked dispatch)
            "mesh": {"spec": args.mesh_spec, "shape": mesh_shape,
                     "devices": mesh_devices},
            "window_ms": round(eff_window_ms, 3),
            "window_ms_live": (round(pool0._window_s * 1e3, 3)
                               if pool0 is not None
                               else round(eff_window_ms, 3)),
            "window_adjusts": int(rt.metrics.counter(
                "scoring.megabatch_window_adjusts").value),
            "dispatches": best["dispatches"],
            "dispatch_rate": best["dispatch_rate"],
            "events_per_dispatch": (round(scored / best["dispatches"], 1)
                                    if best["dispatches"] else 0.0),
            "tenants_per_dispatch_p50": round(rt.metrics.histogram(
                "scoring.megabatch_tenants_per_dispatch").quantile(0.5), 1),
            "stack_rebuilds": int(rt.metrics.counter(
                "scoring.stack_rebuilds").value),
            "ingress_rejected": int(rt.metrics.counter(
                "flow.rejected").value),
            "model": args.model,
        },
        "events_scored": int(scored),
        "seconds": round(best["seconds"], 2),
        "saturation_trials": trials,
        "model": args.model,
        "pallas": status,
        "tenants": len(tenant_ids),
        "model_flops_per_event": flops_ev,
        "model_tflops": round(model_flops_s / 1e12, 3),
        "model_tflops_median": round(model_tflops_median, 4),
        # achieved model TFLOP/s over the devices the dispatch spans
        "model_tflops_per_device": round(
            model_tflops_median / max(mesh_devices or n_chips, 1), 5),
        "mfu": round(mfu, 5) if mfu is not None else None,
        "fleet_devices": args.devices,
        "readback": "anomalies" if sparse else "full",
        "durable": bool(args.durable),
        "durable_spill": spill,
        "observe": observe,
        "chaos": chaos,
        "lint": lint_summary(),
        "chips": n_chips,
        "device_kind": device_kind,
        "platform": platform,
        "drain": {"saturation_complete": best["drain_complete"],
                  "saturation_seconds": round(best["drain_seconds"], 2),
                  "latency_complete": lat_drain_ok,
                  "latency_seconds": round(lat_drain_s, 2)},
    }


# -- --replay -----------------------------------------------------------------

def drop_page_cache() -> bool:
    """Best-effort page-cache drop for the cold replay leg (needs root;
    the report records whether it happened)."""
    try:
        os.sync()
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except OSError:
        return False


async def run_replay(args) -> dict:
    """`bench.py`'s `run_replay_bench` (`:2103-2272`) on
    `tools/replay_bench.py`: the corpus (`--replay-events` over
    `--tenants`, `--devices` a tenant) compacted into the cold tier, an
    untimed warm pass, then `--sat-trials` timed passes."""
    from sitewhere_tpu_torch.history import ReplayEngine
    from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
    from sitewhere_tpu_torch.tools import replay_bench as rb

    platform, device_kind, n_chips = probe(args)
    if args.durable:
        wipe_durable(args.durable, args.force_wipe)
        root = args.durable
    else:
        root = tempfile.mkdtemp(prefix="swx-replay-bench-")
    stores: dict = {}
    try:
        tenants = [f"bench{i}" for i in range(max(args.tenants, 1))]
        per_tenant = max(args.replay_events // len(tenants), 1)
        rng = np.random.default_rng(7)
        corpus_t = time.monotonic()
        compact_segments = compact_events = 0
        compact_s = 0.0
        for tid in tenants:
            store, _, rep, _ = rb.corpus(os.path.join(root, tid), tenant=tid,
                                         events=per_tenant,
                                         devices=args.devices, rng=rng)
            compact_segments += rep["segments"]
            compact_events += rep["events"]
            compact_s += rep["elapsed_s"]
            stores[tid] = store
        corpus_s = time.monotonic() - corpus_t

        metrics = MetricsRegistry()
        pool, _ = rb.pool(args.model, args.window, args.window_ms,
                          args.max_inflight, device=device_arg(args),
                          metrics=metrics)
        engine = ReplayEngine(pool, metrics=metrics)

        async def replay_all() -> int:
            reports = await asyncio.gather(*[
                engine.replay(tid, stores[tid], rb.THRESHOLD)
                for tid in tenants])
            return sum(r["events"] for r in reports)

        try:
            warm_t = time.monotonic()
            await replay_all()  # untimed: every bucket's first dispatch
            warmup_s = time.monotonic() - warm_t
            trials = []
            cache_dropped = None
            for _ in range(max(args.sat_trials, 1)):
                if args.replay_io == "cold":
                    cache_dropped = drop_page_cache()
                t1 = time.monotonic()
                events = await replay_all()
                elapsed = time.monotonic() - t1
                trials.append({"events": events,
                               "elapsed_s": round(elapsed, 4),
                               "events_per_sec": round(events / elapsed, 1)})
        finally:
            pool.close()
        blocks = sum(s.stats()["blocks"] for s in stores.values())
        windows = sum(s.stats()["windows"] for s in stores.values())
        corpus_bytes = sum(s.stats()["bytes"] for s in stores.values())
    finally:
        for s in stores.values():
            s.close()
        if not args.durable:
            shutil.rmtree(root, ignore_errors=True)

    rates = sorted(t["events_per_sec"] for t in trials)
    value, median = rates[-1], rates[len(rates) // 2]
    result = {
        "metric": "replay_events_per_sec",
        "value": value,
        "value_median": median,
        "unit": "events/s",
        "vs_baseline": round(value / 1e6, 4),
        "io": args.replay_io,
        "cache_dropped": cache_dropped,
        "model": args.model,
        "tenants": len(tenants),
        "events": per_tenant * len(tenants),
        "windows": windows,
        "blocks": blocks,
        "corpus_bytes": corpus_bytes,
        "corpus_build_s": round(corpus_s, 2),
        "compact": {"segments": compact_segments,
                    "events": compact_events,
                    "elapsed_s": round(compact_s, 3),
                    "events_per_sec": round(
                        compact_events / compact_s, 1) if compact_s else 0.0},
        "warmup_s": round(warmup_s, 3),
        "trials": trials,
        "platform": platform, "device_kind": device_kind, "chips": n_chips,
        "lint": lint_summary(),
    }
    if args.live_median > 0:
        result["live_saturation_median"] = args.live_median
        result["vs_live_median"] = round(median / args.live_median, 3)
    return result


# -- --split ------------------------------------------------------------------

async def run_split(args) -> dict:
    """`bench.py`'s `run_split_bench` (`:444-616`) on `tools/split.py`:
    the broker, ingress and the meter here, the scorer in a fresh
    interpreter. Events/s is the parent's (scored records read back over
    the broker); the latency is the scorer's (wire decode → scored)."""
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
    from sitewhere_tpu_torch.tools import split as sp

    probe(args)
    cfg = sp.SplitConfig(devices=args.devices, model=args.model,
                         window=args.window, device=device_arg(args),
                         window_ms=args.window_ms,
                         max_inflight=args.max_inflight,
                         history=args.history,
                         timeout_s=args.ready_timeout)
    split = sp.Split(cfg)
    scored_seen = 0

    def drain_scored() -> None:
        nonlocal scored_seen
        for r in split.scored.poll_nowait(max_records=512):
            scored_seen += len(r.value)

    try:
        await split.start()
        sim = DeviceSimulator(SimConfig(num_devices=args.devices,
                                        anomaly_rate=0.001,
                                        anomaly_magnitude=12.0),
                              tenant_id=sp.TENANT)
        t_base = sp.TICK_S * (args.window + 4)
        for k in range(3):  # end-to-end warm, every event back
            await split.submit(sim.payload(t=t_base + k)[0])
        await split.collect(3 * args.devices)
        await split.ok("RESET")

        # phase 1: saturation (open loop + drain)
        t0 = time.monotonic()
        sent = k = 0
        while time.monotonic() - t0 < args.seconds:
            payload, _ = sim.payload(t=t_base + 10 + 0.001 * k)
            if await split.receiver.submit(payload):
                sent += args.devices
            k += 1
            drain_scored()
        deadline = time.monotonic() + args.drain_timeout
        while scored_seen < sent and time.monotonic() < deadline:
            drain_scored()
            await asyncio.sleep(0.02)
        elapsed = time.monotonic() - t0
        sat_ok = scored_seen >= sent
        rate = scored_seen / elapsed if elapsed > 0 else 0.0
        sat_stats = await split.stats()

        # phase 2: paced latency (the scorer's stats, reset first)
        await split.ok("RESET")
        paced_rate = args.paced_fraction * rate
        interval = args.devices / max(paced_rate, 1.0)
        scored_seen = paced_sent = 0
        t1 = next_t = time.monotonic()
        while time.monotonic() - t1 < args.latency_seconds:
            payload, _ = sim.payload(t=t_base + 10_000 + 0.001 * paced_sent)
            if await split.receiver.submit(payload):
                paced_sent += args.devices
            next_t += interval
            delay = next_t - time.monotonic()
            if delay > 0:
                await asyncio.sleep(delay)
            drain_scored()
        deadline = time.monotonic() + args.latency_drain_timeout
        while scored_seen < paced_sent and time.monotonic() < deadline:
            drain_scored()
            await asyncio.sleep(0.02)
        lat_ok = scored_seen >= paced_sent
        stats = await split.stats()
    finally:
        await split.stop()
    if split.proc is not None and split.proc.returncode != 0:
        raise sp.ChildDied(f"the scorer exited with {split.proc.returncode}")
    k1 = cfg.model == "lstm" and not cfg.pooled  # a dedicated window ring
    log_kernels(sat_stats["kernel_launches"] + stats["kernel_launches"],
                sat_stats["dispatches"] + stats["dispatches"],
                ("plain" if args.cpu else "cuda") if k1 else None)
    return {
        "metric": "split_pipeline_scored_events_per_sec",
        "value": round(rate, 1),
        "unit": "events/s",
        "vs_baseline": round(rate / 1_000_000, 4),
        "deployment": "split (broker+ingest | scorer process)",
        "p99_ms": round(stats["e2e_p99_ms"], 3),
        "p50_ms": round(stats["e2e_p50_ms"], 3),
        "p99_breakdown": {nm: {q: round(v, 3) for q, v in row.items()}
                          for nm, row in stats["breakdown"].items()},
        "latency_note": "child-side: wire decode -> scored "
                        "(re-stamped at broker handoff)",
        "paced_rate": round(paced_rate, 1),
        "events_scored": int(scored_seen),
        "seconds": round(elapsed, 2),
        "model": args.model,
        "fleet_devices": args.devices,
        "drain": {"saturation_complete": sat_ok,
                  "latency_complete": lat_ok},
    }


# -- --workers N --------------------------------------------------------------

KILL_KEYS = ("killed_worker", "killed_owned", "death_detected",
             "converged_after_kill_s", "replacement_spawned",
             "accepted_events", "scored_events", "lost_accepted_events",
             "replayed_events", "decoded_backlog_after_drain")
ZOMBIE_KEYS = ("zombie_worker", "zombie_owned",
               "false_positive_death_detected", "declared_dead_s",
               "sigcont_mid_reassignment", "reconverged_after_stop_s",
               "fenced_rejections", "accepted_events", "scored_events",
               "lost_accepted_events", "replayed_events",
               "decoded_backlog_after_drain", "post_reconverge_accepted",
               "duplicate_committed_events")


def fleet_logging() -> None:
    """The controller's placement trail on stderr beside the bench's."""
    logging.getLogger("sitewhere_tpu_torch.fleet").setLevel(logging.INFO)
    logging.getLogger("sitewhere_tpu_torch.tools.fleet").setLevel(
        logging.INFO)


async def drained_or_logged(fleet, timeout: float) -> bool:
    """`Fleet.caught_up` as the bench's `drain_until`: False (with the
    diagnosis on stderr) instead of a raise."""
    try:
        await fleet.caught_up(timeout)
        return True
    except TimeoutError as exc:
        print(f"[bench fleet] {exc}", file=sys.stderr)
        return False


def observe_block(fleet, tenant_ids) -> Optional[dict]:
    """The fleet-observe block (`bench.py:1134-1165`)."""
    controller, rt = fleet.controller, fleet.rt
    if controller.observer is None:
        return None
    obs_snap = controller.observer.snapshot()
    cp = obs_snap["critical_path"]
    history_rows = {}
    if rt.history is not None:
        rt.history.flush()
        history_rows = {tid: len(rt.history.history(tid, "lag"))
                        for tid in tenant_ids}
    broker_stats = obs_snap.get("broker") or {}
    return {
        "workers_reporting": len(obs_snap["workers"]),
        "telemetry_records": obs_snap["telemetry"]["records"],
        "telemetry_lag": obs_snap["telemetry"]["observer_lag"],
        "workers_merged": cp.get("workers_merged", 0),
        "queue_wait_p99_ms": cp["queue_wait_p99_ms"],
        "service_p99_ms": cp["service_p99_ms"],
        "critical_path": cp["stages"],
        "mesh": obs_snap["mesh"],
        "broker": {
            "topics": len(broker_stats.get("topics") or {}),
            "groups": len(broker_stats.get("groups") or {}),
            "fence_rejections": broker_stats.get("fence_rejections", 0),
            "members_evicted": broker_stats.get("members_evicted", 0),
        },
        "history": rt.history.stats() if rt.history is not None else None,
        "history_lag_windows_per_tenant": history_rows,
    }


def fleet_sims(cfg) -> dict:
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    return {tid: DeviceSimulator(
        SimConfig(num_devices=cfg.per_tenant, seed=i, anomaly_rate=0.001,
                  anomaly_magnitude=12.0), tenant_id=tid)
        for i, tid in enumerate(cfg.tenant_ids)}


async def stop_fleet(fleet) -> None:
    """Stop the fleet; a worker that did not leave cleanly on SIGTERM
    (and was not killed by a drill) fails the run. A worker the
    autoscaler spawned that had not come up yet (no API port printed)
    has no SIGTERM handler installed: it ends by the signal."""
    import signal

    from sitewhere_tpu_torch.tools import fleet as fl

    rcs = await fleet.stop()
    bad = {w: rc for w, rc in rcs.items()
           if rc != 0 and w not in fleet.expected_dead
           and not (rc == -signal.SIGTERM and w not in fleet.api_ports)}
    if bad:
        raise fl.WorkerDied(f"fleet workers exited {bad} after SIGTERM")


async def run_fleet(args) -> dict:
    """`bench.py`'s `run_fleet_bench` (`:617-1242`) on `tools/fleet.py`:
    saturation trials with every tenant flooded (32 ticks a tenant
    outstanding at most), the steady critical path, the kill drill
    (SIGKILL of the busiest worker 40% into a flood), the zombie drill,
    and the fleet-observe block."""
    from sitewhere_tpu_torch.tools import fleet as fl

    platform, device_kind, n_chips = probe(args)
    fleet_logging()
    n_workers = max(args.workers, 1)
    cfg = fl.FleetConfig(
        workers=n_workers, devices=args.devices, model=args.model,
        device=device_arg(args), tenants=args.tenants, window=args.window,
        window_ms=args.window_ms, max_inflight=args.max_inflight,
        megabatch=args.megabatch,
        fleet_observe=not args.no_fleet_observe,
        wire_fastpath=not args.no_wire_fastpath, chaos=args.chaos,
        chaos_seed=args.chaos_seed, chaos_faults=args.chaos_faults)
    tenant_ids = cfg.tenant_ids
    fleet = fl.Fleet(cfg)
    try:
        await fleet.start()
        converge_s = fleet.setup_s["converged"] - fleet.setup_s["registry"]
        controller, bus = fleet.controller, fleet.bus
        sims = fleet_sims(cfg)
        t_next = fl.TICK_S * (args.window + 4)
        # warm the whole path (decode → wire → score → wire → meter)
        _, _, t_next = await fleet.flood(sims, t_next, 2.0)
        await drained_or_logged(fleet, args.drain_timeout)

        before = await fleet.worker_stats()
        trials = []
        for _ in range(max(args.sat_trials, 1)):
            base = dict(fleet.scored)
            t0 = time.monotonic()
            _, _, t_next = await fleet.flood(sims, t_next, args.seconds)
            drain_ok = await drained_or_logged(fleet, args.drain_timeout)
            elapsed = time.monotonic() - t0
            got = sum(fleet.scored[t] - base[t] for t in tenant_ids)
            trials.append({
                "rate": round(got / elapsed, 1) if elapsed else 0.0,
                "events_scored": int(got),
                "seconds": round(elapsed, 2),
                "drain_complete": drain_ok,
            })
        clean = [t for t in trials if t["drain_complete"]] or trials
        rate = max(clean, key=lambda t: t["rate"])["rate"]
        rate_median = statistics.median(t["rate"] for t in clean)
        # each worker's K1 launches and dispatches over the trials
        trial_stats = fl.stats_delta(before, await fleet.worker_stats())
        log_kernels(sum(s["kernel_launches"] for s in trial_stats.values()),
                    sum(s["dispatches"] for s in trial_stats.values()),
                    None)

        # the steady critical path, before the drills' backlog
        observe_steady = None
        if controller.observer is not None:
            cp = controller.observer.snapshot()["critical_path"]
            observe_steady = {"queue_wait_p99_ms": cp["queue_wait_p99_ms"],
                              "service_p99_ms": cp["service_p99_ms"],
                              "critical_path": cp["stages"]}

        kill_stats = zombie_stats = None
        if n_workers >= 2 and not args.no_fleet_kill:
            drill, t_next = await fl.kill_drill(fleet, sims, t_next,
                                                seconds=args.seconds)
            print(f"[bench fleet] kill drill {json.dumps(drill)}",
                  file=sys.stderr)
            kill_stats = {k: drill[k] for k in KILL_KEYS}
            kill_stats["drain_complete"] = True  # the drill raises if not
        if n_workers >= 2 and args.zombie_drill:
            drill, t_next = await fl.zombie_drill(fleet, sims, t_next,
                                                  seconds=args.seconds)
            print(f"[bench fleet] zombie drill {json.dumps(drill)}",
                  file=sys.stderr)
            zombie_stats = {k: drill[k] for k in ZOMBIE_KEYS}
            # the drill raises unless both drains complete
            zombie_stats["drain_complete"] = True
            zombie_stats["post_reconverge_drain_complete"] = True

        final = controller.snapshot()
        fleet_observe = observe_block(fleet, tenant_ids)
        chaos = None
        if fleet.faults is not None:
            chaos = {"seed": args.chaos_seed, "sites": fleet.faults.snapshot(),
                     "note": "fleet.heartbeat armed worker-side in "
                             "each worker process (bounded)"}
        return {
            "metric": "fleet_pipeline_scored_events_per_sec",
            "value": round(rate, 1),
            "value_median": round(rate_median, 1),
            "unit": "events/s",
            "vs_baseline": round(rate / 1_000_000, 4),
            "vs_baseline_median": round(rate_median / 1_000_000, 4),
            "deployment": f"fleet (bus+ingress+controller | "
                          f"{n_workers} worker processes)",
            "fleet": {
                "workers": n_workers,
                "tenants": len(tenant_ids),
                "wire_fastpath": cfg.wire_fastpath,
                "aggregate_sat": round(rate, 1),
                "aggregate_sat_median": round(rate_median, 1),
                "rebalances": int(controller.rebalances),
                "epoch": final["epoch"],
                "converge_s": round(converge_s, 2),
                "kill": kill_stats,
                "zombie": zombie_stats,
                "fence_rejections_total": (bus.fences.rejections
                                           if bus.fences is not None
                                           else 0),
                "autoscaler_decisions": controller.decisions[-8:],
                "observe": fleet_observe,
                "observe_steady": observe_steady,
            },
            "saturation_trials": trials,
            "model": args.model,
            "tenants": len(tenant_ids),
            "fleet_devices": args.devices,
            "chaos": chaos,
            "lint": lint_summary(),
            "chips": n_chips, "device_kind": device_kind,
            "platform": platform,
        }
    finally:
        await stop_fleet(fleet)


# -- --ramp -------------------------------------------------------------------

async def run_ramp(args) -> dict:
    """`bench.py`'s `run_ramp_bench` (`:1243-1744`) on `tools/fleet.py`:
    the live autoscaler (1..`--ramp-max-workers`, scale-up disarmed until
    the ramp) and the predictive planner over the controller's 1 s
    history windows (off with `--no-forecast`); calibration, a seed
    phase, the forecaster trained from history, the ramp (a constant
    good tenant, the others climbing to `--ramp-peak` × saturation, the
    last one bursting at the midpoint), the drain with the good tenant
    still paced, and a kill drill when two workers are live."""
    from sitewhere_tpu_torch.fleet import AutoscalerPolicy
    from sitewhere_tpu_torch.tools import fleet as fl

    platform, device_kind, n_chips = probe(args)
    fleet_logging()
    forecast_on = bool(args.forecast)
    cfg = fl.FleetConfig(
        workers=args.ramp_max_workers, devices=args.devices,
        model=args.model, device=device_arg(args),
        tenants=args.tenants if args.tenants > 1 else 4,
        window=args.window, window_ms=args.window_ms,
        max_inflight=args.max_inflight, megabatch=args.megabatch,
        policy=AutoscalerPolicy(min_workers=1,
                                max_workers=args.ramp_max_workers,
                                scale_up_lag=1e18, scale_down_lag=0.0,
                                cooldown_s=8.0, imbalance_ratio=1e18),
        start_workers=1,
        settings={
            # 1 s history windows: the forecaster's timestep
            "observe_history_window_s": 1.0,
            "fleet_forecast": forecast_on,
            "fleet_forecast_window": 16,
            "fleet_forecast_interval_s": 0.5,
            "fleet_forecast_min_windows": 8},
        worker_settings={"observe_export": True, "observe_history": False})
    tenant_ids = cfg.tenant_ids
    per_tenant = cfg.per_tenant
    n_tenants = len(tenant_ids)
    good, burst = tenant_ids[0], tenant_ids[-1]
    ramp_tenants = tenant_ids[1:-1] or [burst]
    fleet = fl.Fleet(cfg)
    try:
        await fleet.start()
        converge_s = fleet.setup_s["converged"] - fleet.setup_s["registry"]
        controller, rt = fleet.controller, fleet.rt
        sims = fleet_sims(cfg)
        receivers = fleet.receivers
        scored, sent_total = fleet.scored, fleet.sent
        good_lat: list[float] = []
        collect_lat = False

        def drain_scored() -> None:
            now = time.time()
            for tid, consumer in fleet.meters.items():
                for record in consumer.poll_nowait(max_records=256):
                    scored[tid] += len(record.value)
                    if collect_lat and tid == good:
                        ts = getattr(record.value, "ts", None)
                        if ts is not None and len(ts):
                            good_lat.append(now - float(ts.max()))

        async def submit(tid: str) -> None:
            payload, _ = sims[tid].payload(t=time.time())
            if await receivers[tid].submit(payload):
                sent_total[tid] += per_tenant

        async def drain_until(bound: float) -> bool:
            deadline = time.monotonic() + bound
            while time.monotonic() < deadline:
                fleet.check_workers()
                drain_scored()
                if all(scored[t] >= sent_total[t] for t in tenant_ids):
                    return True
                await asyncio.sleep(0.05)
            return all(scored[t] >= sent_total[t] for t in tenant_ids)

        async def paced_phase(seconds: float, rate_fn, *,
                              kill_at: float = -1.0):
            """Offered load paced per tenant by `rate_fn(elapsed)`;
            integrates outstanding accepted events over wall time."""
            next_due = {tid: time.monotonic() for tid in tenant_ids}
            t0 = last_sample = time.monotonic()
            backlog_es, backlog_peak = 0.0, 0
            timeline, next_timeline = [], 0.0
            kill_info = None
            while time.monotonic() - t0 < seconds:
                now = time.monotonic()
                el = now - t0
                for tid, ev_s in rate_fn(el).items():
                    if ev_s <= 0.0 or now < next_due[tid]:
                        continue
                    interval = per_tenant / ev_s
                    await submit(tid)
                    # late iterations must not compound into a burst
                    next_due[tid] = max(next_due[tid] + interval,
                                        now - interval)
                if kill_at >= 0 and kill_info is None and el >= kill_at:
                    victim, owned = fleet.busiest()
                    if victim is not None:
                        fleet.expected_dead.add(victim)
                        fleet.procs[victim].kill()
                        kill_info = {"worker": victim, "owned": list(owned),
                                     "t_kill": time.monotonic()}
                        print(f"[ramp bench] SIGKILL {victim}",
                              file=sys.stderr)
                fleet.check_workers()
                drain_scored()
                now2 = time.monotonic()
                outstanding = sum(sent_total[t] - scored[t]
                                  for t in tenant_ids)
                backlog_es += max(outstanding, 0) * (now2 - last_sample)
                backlog_peak = max(backlog_peak, outstanding)
                last_sample = now2
                if el >= next_timeline:
                    timeline.append({
                        "t": round(el, 1),
                        "outstanding": int(outstanding),
                        "workers_live": len(
                            controller.snapshot()["workers"])})
                    next_timeline = el + 2.0
                await asyncio.sleep(0.004)
            return backlog_es, backlog_peak, timeline, kill_info

        outstanding_cap = per_tenant * 16

        async def flood(seconds: float) -> None:
            t_f = time.monotonic()
            while time.monotonic() - t_f < seconds:
                progressed = False
                for tid in tenant_ids:
                    if sent_total[tid] - scored[tid] >= outstanding_cap:
                        continue
                    before = sent_total[tid]
                    await submit(tid)
                    progressed = progressed or sent_total[tid] > before
                fleet.check_workers()
                drain_scored()
                if not progressed:
                    await asyncio.sleep(0.002)

        # an uncounted warm flood first: first dispatches land here, not
        # in the calibration window
        await flood(3.0)
        if args.ramp_sat_rate > 0:
            # pinned: an A/B pair runs leg A's rate on leg B
            sat_rate = float(args.ramp_sat_rate)
        else:
            base = dict(scored)
            t0 = time.monotonic()
            await flood(5.0)
            sat_rate = sum(scored[t] - base[t] for t in tenant_ids) \
                / (time.monotonic() - t0)
        await drain_until(args.drain_timeout)
        sat_rate = max(sat_rate, float(n_tenants))  # degenerate-rig floor
        print(f"[ramp bench] single-worker saturation ≈ "
              f"{sat_rate:,.0f} ev/s", file=sys.stderr)

        good_hz = 0.04 * sat_rate
        seed_hz = 0.03 * sat_rate
        peak_each = (args.ramp_peak - 0.04) * sat_rate \
            / max(len(ramp_tenants) + 1, 1)

        def seed_rates(_el):
            rates = {tid: seed_hz for tid in tenant_ids}
            rates[good] = good_hz
            return rates

        def ramp_rates(el):
            frac = min(el / max(args.ramp_seconds, 1e-9), 1.0)
            rates = {good: good_hz}
            for tid in ramp_tenants:
                rates[tid] = seed_hz + (peak_each - seed_hz) * frac
            rates[burst] = (peak_each if el >= 0.5 * args.ramp_seconds
                            else seed_hz)
            return rates

        # seed: steady light load builds the history the forecaster
        # trains on; the autoscaler's own load signal is sampled through
        # it (its noise floor anchors the armed bar)
        seed_load_samples: list[float] = []

        async def seed_load_sampler():
            while True:
                loads = controller.worker_loads()
                if loads:
                    seed_load_samples.append(max(loads.values()))
                await asyncio.sleep(0.5)

        sampler = asyncio.ensure_future(seed_load_sampler())
        try:
            await paced_phase(args.ramp_seed_seconds, seed_rates)
            await drain_until(args.drain_timeout)
        finally:
            sampler.cancel()
            await asyncio.gather(sampler, return_exceptions=True)

        # the forecast leg trains through the planner's own path
        train_report = None
        if forecast_on:
            t_wait = time.monotonic()
            while controller.planner is None \
                    and time.monotonic() - t_wait < 15.0:
                await asyncio.sleep(0.25)
            if controller.planner is not None:
                train_report = controller.planner.train_from_history(
                    steps=80)
                print(f"[ramp bench] forecaster trained: {train_report}",
                      file=sys.stderr)

        # the armed bar: above the seed's noise floor (its p90) and a
        # share of saturation; pinned outright with --ramp-sat-rate
        seed_load_peak = max(seed_load_samples, default=0.0)
        seed_load_p90 = (float(np.quantile(seed_load_samples, 0.9))
                         if seed_load_samples else 0.0)
        armed_bar = (float(args.ramp_scale_lag) if args.ramp_sat_rate > 0
                     else max(args.ramp_scale_lag, 2.0 * seed_load_p90,
                              0.3 * sat_rate))
        controller.policy = dataclasses.replace(
            controller.policy, scale_up_lag=armed_bar)  # armed
        controller._last_scale_t = -1e9  # no cooldown debt from set-up
        collect_lat = True
        backlog_es, backlog_peak, timeline, _ = await paced_phase(
            args.ramp_seconds, ramp_rates)
        # the drain counts too, the good tenant still paced through it
        t_drain0 = last = time.monotonic()
        drain_deadline = t_drain0 + args.drain_timeout + 120.0
        good_interval = per_tenant / max(good_hz, 1e-9)
        next_good = t_drain0
        while time.monotonic() < drain_deadline:
            now2 = time.monotonic()
            if now2 >= next_good:
                await submit(good)
                next_good = max(next_good + good_interval,
                                now2 - good_interval)
            fleet.check_workers()
            drain_scored()
            now2 = time.monotonic()
            outstanding = sum(sent_total[t] - scored[t] for t in tenant_ids)
            backlog_es += max(outstanding, 0) * (now2 - last)
            backlog_peak = max(backlog_peak, outstanding)
            last = now2
            if sum(sent_total[t] - scored[t] for t in tenant_ids
                   if t != good) <= 0:
                break
            await asyncio.sleep(0.05)
        ramp_drain_ok = sum(sent_total[t] - scored[t] for t in tenant_ids
                            if t != good) <= 0
        collect_lat = False
        ramp_drain_s = round(time.monotonic() - t_drain0, 2)
        lat = (np.sort(np.asarray(good_lat, np.float64)) if good_lat
               else np.zeros(1))
        good_p50 = float(lat[int(0.50 * (len(lat) - 1))]) * 1e3
        good_p99 = float(lat[int(0.99 * (len(lat) - 1))]) * 1e3

        # the kill drill: 0 lost with the autoscaler live
        kill_stats = None
        if len(fleet.live()) >= 2 and not args.no_fleet_kill:
            deaths = rt.metrics.counter("fleet.worker_deaths")
            deaths0 = deaths.value
            _, _, _, kill_info = await paced_phase(12.0, seed_rates,
                                                   kill_at=2.0)
            reassigned_s = None
            if kill_info is not None:
                t_wait = time.monotonic()
                while time.monotonic() - t_wait < 120.0:
                    snap = controller.snapshot()
                    if kill_info["worker"] not in snap["workers"] \
                            and snap["converged"]:
                        reassigned_s = round(
                            time.monotonic() - kill_info["t_kill"], 2)
                        break
                    drain_scored()
                    await asyncio.sleep(0.25)
            drain_ok = await drain_until(args.drain_timeout + 120.0)
            lost = sum(max(sent_total[t] - scored[t], 0) for t in tenant_ids)
            kill_stats = {
                "killed_worker": (kill_info or {}).get("worker"),
                "death_detected": bool(deaths.value > deaths0),
                "converged_after_kill_s": reassigned_s,
                "lost_accepted_events": int(lost),
                "drain_complete": drain_ok,
            }

        final = controller.snapshot()
        decisions = list(controller.decisions)
        planner_snap = (controller.planner.snapshot()
                        if controller.planner is not None else None)
        return {
            "metric": "ramp_backlog_event_seconds",
            "value": round(backlog_es, 1),
            "unit": "event-seconds",
            "vs_baseline": 0.0,
            "deployment": f"ramp (bus+ingress+controller | live "
                          f"autoscaler 1..{args.ramp_max_workers})",
            "forecast_enabled": forecast_on,
            "ramp": {
                "saturation_rate": round(sat_rate, 1),
                "scale_up_lag_armed": round(armed_bar, 1),
                "seed_load_peak": round(seed_load_peak, 1),
                "peak_multiple": args.ramp_peak,
                "seconds": args.ramp_seconds,
                "seed_seconds": args.ramp_seed_seconds,
                "backlog_event_seconds": round(backlog_es, 1),
                "backlog_peak_events": int(backlog_peak),
                "ramp_drain_s": ramp_drain_s,
                "ramp_drain_complete": ramp_drain_ok,
                "good_tenant": good,
                "good_paced_p50_ms": round(good_p50, 2),
                "good_paced_p99_ms": round(good_p99, 2),
                "good_samples": len(good_lat),
                "timeline": timeline,
                "workers_final": len(final["workers"]),
                "converge_s": round(converge_s, 2),
                "train": train_report,
                "decisions": decisions,
                "forecast_attributed_decisions": len(
                    [d for d in decisions if "forecast" in d]),
                "forecast_counters": {
                    "decisions": rt.metrics.counter(
                        "fleet.forecast_decisions").value,
                    "demotions": rt.metrics.counter(
                        "fleet.forecast_demotions").value,
                    "trainings": rt.metrics.counter(
                        "fleet.forecast_trainings").value,
                },
                "planner": planner_snap,
                "kill": kill_stats,
            },
            "model": args.model,
            "tenants": n_tenants,
            "fleet_devices": args.devices,
            "lint": lint_summary(),
            "chips": n_chips, "device_kind": device_kind,
            "platform": platform,
        }
    finally:
        await stop_fleet(fleet)


# -- --gnn, --train -----------------------------------------------------------

def maintenance_fleet(n: int, window: int, seed: int = 7):
    """The GNN bench's fleet (`bench.py:1774-1802`): `n` pumps over
    n/50 assets and n/200 areas under one site, W+4 ticks of telemetry
    (simulator seed `seed`); returns (device management, store)."""
    from sitewhere_tpu_torch.domain.model import (
        Area,
        Asset,
        Device,
        DeviceAssignment,
        DeviceType,
    )
    from sitewhere_tpu_torch.persistence.memory import InMemoryDeviceManagement
    from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    dm = InMemoryDeviceManagement()
    dt = DeviceType(token="pump", name="Pump")
    dm.create_device_type(dt)
    assets = [Asset(token=f"asset-{i}", name=f"A{i}")
              for i in range(max(n // 50, 1))]
    parent = Area(token="site", name="Site")
    areas = [parent] + [Area(token=f"area-{i}", name=f"Z{i}",
                             parent_area_id=parent.id)
                        for i in range(max(n // 200, 1))]
    for ar in areas:
        dm.create_area(ar)
    for i in range(n):
        d = dm.create_device(Device(token=f"p-{i}", device_type_id=dt.id))
        dm.create_device_assignment(DeviceAssignment(
            device_id=d.id, token=f"p-{i}-a",
            asset_id=assets[i % len(assets)].id,
            area_id=(areas[1 + i % (len(areas) - 1)].id
                     if len(areas) > 1 else parent.id)))
    store = TelemetryStore(history=window * 2, initial_devices=n)
    sim = DeviceSimulator(SimConfig(num_devices=n, seed=seed),
                          tenant_id="bench")
    for k in range(window + 4):
        store.append_measurements(sim.tick(t=60.0 * k)[0])
    return dm, store


def run_gnn(args) -> dict:
    """`bench.py`'s `run_gnn_bench` (`:1745-1833`): graph build (host)
    and GNN risk scoring (device) at `GNN_SIZES`; `value` is the largest
    fleet's scoring rate (devices × iterations / seconds after a warm
    call)."""
    import torch

    from sitewhere_tpu_torch.models.graph import build_fleet_graph
    from sitewhere_tpu_torch.training.maintenance import (
        MaintenanceTrainer,
        build_maintenance_model,
    )

    platform, device_kind, n_chips = probe(args)
    model = build_maintenance_model(device=device_arg(args))
    trainer = MaintenanceTrainer(model)
    params = model.init(torch.Generator().manual_seed(0))
    per_size = {}
    for n in GNN_SIZES:
        dm, store = maintenance_fleet(n, args.window)
        t0 = time.monotonic()
        graph = build_fleet_graph(dm, store, window=args.window)
        build_s = time.monotonic() - t0
        trainer.score(params, graph)  # warm at this padded shape
        iters = 0
        t0 = time.monotonic()
        while time.monotonic() - t0 < max(args.seconds / 2, 2.0):
            risk = trainer.score(params, graph)
            iters += 1
        elapsed = time.monotonic() - t0
        if risk.shape[0] != n or not np.isfinite(risk).all():
            raise AssertionError(f"gnn: risk {risk.shape} for {n} devices, "
                                 f"finite {np.isfinite(risk).all()}")
        per_size[str(n)] = {
            "graph_build_ms": round(build_s * 1e3, 1),
            "graph_nodes": graph.n_pad,
            "risk_scores_per_sec": round(n * iters / elapsed, 1),
            "scoring_iters": iters,
        }
    top = per_size[str(GNN_SIZES[-1])]
    return {
        "metric": "gnn_fleet_risk_scores_per_sec",
        "value": top["risk_scores_per_sec"],
        "unit": "device-risk-scores/s",
        "vs_baseline": 0.0,  # no reference GNN plane exists
        "fleet_sizes": per_size,
        "model": "gnn",
        "platform": platform, "device_kind": device_kind, "chips": n_chips,
    }


def run_train(args) -> dict:
    """`bench.py`'s `run_train_bench` (`:1834-1878`): ETL windows/s and
    train steps/s for `--model` (lstm-stream trains as lstm)."""
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.training.trainer import (
        Trainer,
        TrainerConfig,
        make_windows,
    )

    platform, device_kind, n_chips = probe(args)
    model = build_model("lstm" if args.model == "lstm-stream" else args.model,
                        device=device_arg(args), window=args.window)
    rng = np.random.default_rng(0)
    values = rng.standard_normal(
        (args.devices, args.history)).astype(np.float32)
    counts = np.full(args.devices, args.history)
    t0 = time.monotonic()
    windows, valid = make_windows(values, counts, window=args.window,
                                  max_windows=1_000_000)
    etl_s = time.monotonic() - t0
    trainer = Trainer(model, TrainerConfig(batch_size=2048, steps=20,
                                           log_every=20))
    trainer.train(windows[:4096], valid[:4096])  # first steps, untimed
    t0 = time.monotonic()
    _, report = trainer.train(windows, valid)
    train_s = time.monotonic() - t0
    steps = report["steps"]
    return {
        "metric": "train_windows_per_sec",
        "value": round(steps * 2048 / train_s, 1),
        "unit": "windows/s",
        "vs_baseline": 0.0,  # no reference training plane exists
        "etl_windows_per_sec": round(windows.shape[0] / etl_s, 1),
        "etl_seconds": round(etl_s, 3),
        "steps_per_sec": round(steps / train_s, 2),
        "final_loss": report["final_loss"],
        "model": args.model, "platform": platform,
        "device_kind": device_kind, "chips": n_chips,
    }


# -- --overload ---------------------------------------------------------------

async def run_overload(args) -> dict:
    """`bench.py`'s `run_overload_bench` (`:1879-2088`): one hog tenant
    at `--hog-multiple` × its quota beside `--overload-tenants`
    well-behaved tenants at half theirs; a baseline phase (the
    well-behaved alone) and a contended one. `value` is the worst
    well-behaved tenant's contended goodput over its baseline."""
    from sitewhere_tpu_torch.cli import build_runtime
    from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
    from sitewhere_tpu_torch.domain.model import DeviceType
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    platform, device_kind, n_chips = probe(args)
    devices = args.overload_devices
    quota = args.quota
    window = 32
    good_ids = [f"good{i}" for i in range(args.overload_tenants)]
    all_ids = good_ids + ["hog"]
    rt = build_runtime(InstanceSettings(
        instance_id="overload-bench", device=device_arg(args),
        engine_ready_timeout_s=args.ready_timeout))
    await rt.start()
    consumers = {}
    try:
        for tid in all_ids:
            await rt.add_tenant(TenantConfig(tenant_id=tid, sections={
                "flow": {"rate": quota, "burst": quota},
                "event-management": {"history": window * 2},
                "rule-processing": {
                    "model": "zscore",
                    "model_config": {"window": window},
                    "threshold": 6.0, "batch_window_ms": args.window_ms,
                    "buckets": [devices], "capacity": devices,
                    "max_inflight": args.max_inflight,
                },
            }), timeout=args.ready_timeout)
        sims, receivers, sessions = {}, {}, {}
        for tid in all_ids:
            rt.api("device-management").management(tid).bootstrap_fleet(
                DeviceType(token="thermo", name="T"), devices)
            em = rt.api("event-management").management(tid)
            sim = DeviceSimulator(SimConfig(num_devices=devices),
                                  tenant_id=tid)
            for k in range(window + 4):
                em.telemetry.append_measurements(sim.tick(t=60.0 * k)[0])
            sims[tid] = sim
            receivers[tid] = rt.api("event-sources").engine(tid) \
                .receiver("default")
            sessions[tid] = rt.api("rule-processing").engine(tid).session
        t_warm = time.monotonic()
        while not all(s.ready for s in sessions.values()):
            await asyncio.sleep(0.1)
            if time.monotonic() - t_warm > args.ready_timeout:
                raise TimeoutError("scoring warmup timed out")
        for s in sessions.values():
            s.reload_history()

        scored_counts = {tid: 0 for tid in all_ids}
        consumers = {tid: rt.bus.subscribe(
            rt.naming.tenant_topic(tid, "scored-events"),
            group="overload-bench-meter") for tid in all_ids}

        def drain_scored():
            for tid, c in consumers.items():
                for r in c.poll_nowait(max_records=512):
                    scored_counts[tid] += len(r.value)

        lat_hist = sessions["hog"].latency  # the shared registry histogram

        async def drive(tids_rates: dict, seconds: float) -> dict:
            """Paced open-loop load a tenant; {offered, accepted} each (a
            False submit is shed at ingress)."""
            t0 = time.monotonic()
            stats = {tid: {"offered": 0, "accepted": 0}
                     for tid in tids_rates}
            next_t = {tid: t0 for tid in tids_rates}
            interval = {tid: devices / rate
                        for tid, rate in tids_rates.items()}
            k = 0
            while time.monotonic() - t0 < seconds:
                now = time.monotonic()
                soonest = now + 1.0
                for tid in tids_rates:
                    if next_t[tid] <= now:
                        payload, _ = sims[tid].payload(
                            t=60.0 * (window + 10) + 0.001 * k)
                        k += 1
                        ok = await receivers[tid].submit(payload)
                        stats[tid]["offered"] += devices
                        if ok:
                            stats[tid]["accepted"] += devices
                        next_t[tid] += interval[tid]
                    soonest = min(soonest, next_t[tid])
                drain_scored()
                delay = soonest - time.monotonic()
                await asyncio.sleep(min(delay, 0.05) if delay > 0 else 0)
            return stats

        async def settle(bound: float) -> None:
            deadline = time.monotonic() + bound
            last = sum(scored_counts.values())
            quiet_since = time.monotonic()
            while time.monotonic() < deadline:
                drain_scored()
                total = sum(scored_counts.values())
                if total != last:
                    last, quiet_since = total, time.monotonic()
                elif time.monotonic() - quiet_since > 1.0:
                    break
                await asyncio.sleep(0.05)

        def phase_latency() -> dict:
            return {"p50_ms": round(lat_hist.quantile(0.5) * 1e3, 3),
                    "p95_ms": round(lat_hist.quantile(0.95) * 1e3, 3),
                    "p99_ms": round(lat_hist.quantile(0.99) * 1e3, 3)}

        good_rate = 0.5 * quota
        # phase A: the well-behaved tenants alone
        drain_scored()
        for tid in all_ids:
            scored_counts[tid] = 0
        lat_hist.reset()
        t0 = time.monotonic()
        base_stats = await drive({tid: good_rate for tid in good_ids},
                                 args.seconds)
        await settle(args.drain_timeout)
        base_elapsed = time.monotonic() - t0
        baseline = {tid: scored_counts[tid] / base_elapsed
                    for tid in good_ids}
        base_lat = phase_latency()
        # phase B: the same load and the hog
        for tid in all_ids:
            scored_counts[tid] = 0
        lat_hist.reset()
        rates = {tid: good_rate for tid in good_ids}
        rates["hog"] = args.hog_multiple * quota
        t0 = time.monotonic()
        cont_stats = await drive(rates, args.seconds)
        await settle(args.drain_timeout)
        cont_elapsed = time.monotonic() - t0
        contended = {tid: scored_counts[tid] / cont_elapsed
                     for tid in all_ids}
        cont_lat = phase_latency()
        snap = rt.metrics.snapshot()
        shed = {tid: snap.get(f"flow.rejected:{tid}", 0.0) for tid in all_ids}
    finally:
        for c in consumers.values():
            c.close()
        await rt.stop()
    ratios = {tid: (contended[tid] / baseline[tid]) if baseline[tid] else 0.0
              for tid in good_ids}
    worst = min(ratios.values()) if ratios else 0.0
    return {
        "metric": "overload_goodput_retention",
        "value": round(worst, 4),
        "unit": "fraction_of_baseline",
        "vs_baseline": round(worst, 4),
        "quota_events_per_sec": quota,
        "hog_offered_multiple": args.hog_multiple,
        "hog_goodput": round(contended["hog"], 1),
        "hog_vs_quota": round(contended["hog"] / quota, 3),
        "well_behaved_baseline": {t: round(v, 1) for t, v in baseline.items()},
        "well_behaved_contended": {t: round(contended[t], 1)
                                   for t in good_ids},
        "goodput_ratios": {t: round(v, 4) for t, v in ratios.items()},
        "shed_events": {t: int(v) for t, v in shed.items()},
        "offered": {t: s["offered"] for t, s in cont_stats.items()},
        "accepted": {t: s["accepted"] for t, s in cont_stats.items()},
        "baseline_latency": base_lat,
        "contended_latency": cont_lat,
        "baseline_offered": {t: s["offered"] for t, s in base_stats.items()},
        "tenants": len(all_ids),
        "fleet_devices_per_tenant": devices,
        "model": "zscore",
        "seconds": round(cont_elapsed, 2),
        "platform": platform, "device_kind": device_kind, "chips": n_chips,
        "lint": lint_summary(),
    }


# -- the entry ----------------------------------------------------------------

def parser() -> argparse.ArgumentParser:
    """`bench.py`'s flags (`:2801-3042`), names and defaults, with
    `--cpu` for `--force-cpu` and without the supervisor's
    `--probe-only`, `--inner` and `--probe-horizon`."""
    p = argparse.ArgumentParser(
        prog="python -m sitewhere_tpu_torch.tools.bench")
    add = p.add_argument
    add("--model", default="lstm-stream",
        choices=["lstm", "lstm-stream", "zscore", "tft", "longwin",
                 "seasonal"])
    add("--devices", type=int, default=32768)
    add("--seconds", type=float, default=10.0)
    add("--sat-trials", type=int, default=3,
        help="independent saturation windows; the best clean one is "
             "reported, every trial recorded")
    add("--window", type=int, default=64)
    add("--window-ms", type=float, default=2.0)
    add("--history", type=int, default=256)
    add("--latency-seconds", type=float, default=5.0)
    add("--paced-fraction", type=float, default=0.5,
        help="phase-2 offered load as a fraction of the saturation rate")
    add("--pooled", type=int, default=1, metavar="T",
        help="T tenants share one stacked scoring pool")
    add("--tenants", type=int, default=1, metavar="N",
        help="active tenant count (the fleet split N ways)")
    add("--megabatch", dest="megabatch", action="store_true", default=True,
        help="score through the cross-tenant megabatch pool (default)")
    add("--no-megabatch", dest="megabatch", action="store_false",
        help="dedicated per-tenant sessions (a windowed lstm then "
             "launches K1)")
    add("--mesh", default=None, metavar="DxM",
        help="shard the megabatch dispatch over a {data: D, model: M} "
             "device mesh (tenant rows on `model`, batch columns on "
             "`data`), fitted to the devices there are")
    add("--egress-autotune", action="store_true")
    add("--max-inflight", type=int, default=8)
    add("--drain-timeout", type=float, default=60.0)
    add("--latency-drain-timeout", type=float, default=30.0)
    add("--ready-timeout", type=float, default=300.0)
    add("--profile", default=None, metavar="DIR",
        help="write a torch.profiler trace of phase 1 to DIR/trace.json")
    add("--debug-stages", action="store_true")
    add("--train", action="store_true")
    add("--split", action="store_true")
    add("--workers", type=int, default=0, metavar="N")
    add("--no-fleet-kill", action="store_true")
    add("--no-fleet-observe", action="store_true")
    add("--no-wire-fastpath", action="store_true")
    add("--ramp", action="store_true")
    add("--ramp-seconds", type=float, default=45.0)
    add("--ramp-seed-seconds", type=float, default=25.0)
    add("--ramp-peak", type=float, default=1.4)
    add("--ramp-max-workers", type=int, default=3)
    add("--ramp-scale-lag", type=float, default=1500.0)
    add("--ramp-sat-rate", type=float, default=0.0)
    add("--no-forecast", dest="forecast", action="store_false", default=True)
    add("--zombie-drill", action="store_true")
    add("--gnn", action="store_true")
    add("--overload", action="store_true")
    add("--overload-tenants", type=int, default=3)
    add("--overload-devices", type=int, default=1024)
    add("--quota", type=float, default=5000.0)
    add("--hog-multiple", type=float, default=10.0)
    add("--replay", action="store_true")
    add("--replay-io", default="warm", choices=["cold", "warm"])
    add("--replay-events", type=int, default=500_000)
    add("--live-median", type=float, default=0.0)
    add("--readback", default="full", choices=["full", "anomalies"])
    add("--durable", default=None, metavar="DIR")
    add("--force-wipe", action="store_true")
    add("--chaos", action="store_true")
    add("--chaos-seed", type=int, default=0)
    add("--chaos-faults", type=int, default=4)
    add("--no-observe", action="store_true")
    add("--no-fastlane", action="store_true")
    add("--no-egress-fusion", action="store_true")
    add("--egress-lanes", type=int, default=1, metavar="N")
    add("--cpu", action="store_true",
        help="run on the CPU (bench.py's --force-cpu); without it the "
             "entry runs on the CUDA card or fails")
    return p


def mesh_spec_of(text: Optional[str]) -> Optional[dict]:
    """`--mesh DxM` as `{data: D, model: M}`; ValueError if malformed."""
    if not text:
        return None
    d, _, m = text.lower().partition("x")
    spec = {"data": int(d), "model": int(m or 1)}
    if spec["data"] < 1 or spec["model"] < 1:
        raise ValueError(f"--mesh axes must be positive, got {text!r}")
    return spec


def run(args) -> dict:
    """The mode the flags select, in `bench.py`'s order of precedence."""
    args.mesh_spec = mesh_spec_of(args.mesh)
    if args.train:
        return run_train(args)
    if args.gnn:
        return run_gnn(args)
    for flag, mode in ((args.replay, run_replay), (args.split, run_split),
                       (args.ramp, run_ramp), (args.workers > 0, run_fleet),
                       (args.overload, run_overload)):
        if flag:
            return asyncio.run(mode(args))
    return asyncio.run(run_default(args))


def main(argv=None) -> int:
    p = parser()
    args = p.parse_args(argv)
    if args.split and args.readback != "full":
        # the split's drain counts full scored batches
        p.error("--readback anomalies is not supported with --split "
                "(child-side drain counts full batches)")
    if args.egress_autotune and args.workers > 0:
        p.error("--egress-autotune is not threaded into the fleet "
                "bench's worker config; run it without --workers")
    try:
        mesh_spec_of(args.mesh)
    except ValueError:
        p.error(f"--mesh wants DxM (e.g. 4x2) with positive axes, got "
                f"{args.mesh!r}")
    if args.mesh and not args.megabatch:
        p.error("--mesh shards the megabatch pool's stacked dispatch; "
                "drop --no-megabatch")
    if args.mesh and args.workers > 0:
        p.error("--mesh is not threaded into the fleet bench's worker "
                "config; run it without --workers")
    logging.basicConfig(level=logging.WARNING)
    try:
        result = run(args)
    except Exception as exc:  # noqa: BLE001 - the artifact must parse
        traceback.print_exc()
        print(error_artifact(args, f"{type(exc).__name__}: {exc}"),
              flush=True)
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
