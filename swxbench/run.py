"""Run one cell of the benchmark once and print its result line.

    python -m swxbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run builds the cell's deployment on the
CUDA card through the port's runtime API (`deploy.py`), draws the model's
weights on the card and the traffic from `--seed`, warms up, drives the
window (`window.py`), drains, checks what the window produced against the
plain reference (`check.py`), and prints one JSON line last on standard
output: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device`, with a
trace `breakdown`, and last `checks`, each compared number beside its
limit (also the last lines on standard error). It exits non-zero with no
result line when the cell is unknown, when there is no CUDA card or too
few, when the port is not in the checkout, or when JAX or the JAX
package was loaded.
"""

from __future__ import annotations

import argparse
import asyncio
import gc
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from swxbench import spec

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "sitewhere_tpu"})
CACHE = spec.ROOT / "build" / "swxbench-cache"
EXIT_SPEC, EXIT_NO_CARD, EXIT_NO_PORT, EXIT_JAX = 2, 3, 4, 5
# the program's own counts of shed and dropped work, printed beside a run
SHED_COUNTERS = ("flow.rejected", "flow.shed_degrade", "flow.shed_defer",
                 "scoring.admissions_dropped", "fastlane.records_lost")


def process_start() -> float:
    """This process's start on the monotonic clock (Linux)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.monotonic() - (time.clock_gettime(time.CLOCK_BOOTTIME)
                               - start)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (`sitewhere_tpu_torch` is not `sitewhere_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def set_cache_dirs() -> None:
    """Fixed compile caches inside the checkout (the port builds its own
    kernels into `build/torch_kernels/`)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


@dataclass
class RunView:
    """What the metric readers see of one run."""
    record: object
    scored: object
    stretch: object
    trace: dict | None
    setup_s: float
    widths: dict
    flops_per_event: float
    on_card: bool

    def message_latency_s(self):
        """Due time → last scored record, for each message due in the
        window (inf where a message was rejected or not finished)."""
        rec = self.record
        first, n = rec.first_window_message, rec.messages
        if n <= first:
            return None
        last = np.full(n, -np.inf)
        m = self.scored.message
        ok = (m >= 0) & (m < n)
        np.maximum.at(last, m[ok], self.scored.arrival[ok])
        due = np.asarray(rec.due)
        lat = last - due
        lat[~np.asarray(rec.accepted, bool)] = np.inf
        lat[~np.isfinite(last)] = np.inf
        return lat[first:]


def _check(name: str, value, limit) -> dict:
    return {"name": name, "value": value, "limit": limit}


async def run_cell(cell, seed: int, seconds: float, trace: bool,
                   t_start: float, device=None) -> dict:
    """One run of `cell`; `device` None is the card (the CPU only in the
    harness's own tests)."""
    import torch

    from swxbench import check
    from swxbench.deploy import deploy
    from swxbench.generator import TrafficPlan
    from swxbench.trace import Stretch
    from swxbench.window import run as run_window

    cfg = cell.config
    ref = cell.reference()
    widths = cfg["widths"]
    on = "cuda" if device is None else device
    plan = TrafficPlan(cell.traffic, cfg["devices"], cfg["warm_ticks"], seed)
    plan.prefill(seconds)
    params = ref.make_params(widths, seed, on)
    sample_rate = 1 if trace else cfg["instance"]["trace_sample"]
    dep = await deploy(cfg, plan.warm, plan.tick_s, params, sample_rate,
                       device=device)
    stretch = Stretch() if trace else None
    try:
        record = await run_window(dep, plan, seconds, stretch)
        peak = (int(torch.cuda.max_memory_allocated())
                if torch.cuda.is_available() else 0)
        scored = check.flatten(record)
        tally = check.tally(record, scored)
        threshold = float(cfg["sections"]["rule-processing"]["threshold"])
        flags = check.flag_mismatches(scored, threshold)
        sample = check.sample_devices(plan.devices, int(cfg["sample_devices"]),
                                      seed)
        persisted = check.persisted_mismatches(
            record, dep.em, sample,
            int(cfg["sections"]["event-management"]["history"]))
        groups = check.sent_sequences(record, sample)
        served = {g: check.served_scores(scored, devs, msgs)
                  for g, (devs, msgs) in groups.items()}
        shed = {name: dep.counter(name) for name in SHED_COUNTERS}
    finally:
        await dep.stop()
    del dep
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    # the reference: float32, TF32 off, the configuration's product dtype
    rdt = getattr(torch, cfg["compute_dtype"])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gap, worst = 0.0, {}
        for g, (devs, msgs) in groups.items():
            values = torch.from_numpy(check.sent_values(plan, devs, msgs)).to(on)
            want = ref.scores(params, widths, values, plan.warm_ticks,
                              rdt).cpu().numpy()
            g_gap = check.score_gap(served[g], want)
            if g_gap >= gap:
                worst = check.gap_worst(served[g], want)
            gap = max(gap, g_gap)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    reduced = stretch.reduce() if stretch is not None else None
    view = RunView(record, scored, stretch, reduced,
                   record.t_window0 - t_start, widths,
                   ref.flops_per_event(widths), torch.cuda.is_available())
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.read(view)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    limit = float(cell.limits["score_gap"]["limit"])
    checks = [
        _check("undrained", int(not record.drained), 0),
        _check("lost", tally.lost, 0),
        _check("duplicated", tally.duplicated, 0),
        _check("unknown", tally.unknown, 0),
        _check("flags", flags, 0),
        _check("persisted", persisted, 0),
        _check("score_gap", gap, limit),
    ]
    correct = (bool(record.drained) and tally.lost == 0
               and tally.duplicated == 0 and tally.unknown == 0
               and flags == 0 and persisted == 0 and gap <= limit)
    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    dev = {"platform": "gpu" if torch.cuda.is_available() else "cpu",
           "kind": kind, "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": tally.attempted,
           "failed": tally.failed, "metrics": metrics, "device": dev}
    if reduced is not None:
        dev["busy_s"] = reduced["busy_us"] / 1e6
        dev["window_s"] = reduced["window_us"] / 1e6
        top = sorted(reduced["by_kernel_us"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = {
            "device_ops": [[name, us / 1e6] for name, us in top[:10]],
            "idle_gaps": reduced["idle_gaps"][:10]}
    out["notes"] = {
        "messages": record.messages - record.first_window_message,
        "tails_ms": _tails_ms(view),
        "rejections": record.rejections,
        "drain_s": record.t_drained - record.t_window1,
        "lateness_p99_ms": _lateness_p99_ms(record),
        "sample_devices": int(sample.shape[0]),
        "score_gap_worst": worst,
        "program_counters": shed,
    }
    if stretch is not None:
        out["notes"]["spans_evicted"] = stretch.evicted
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    return out


def _tails_ms(view) -> dict:
    """A paced run's p95 and p99 from due time (printed, not metrics:
    their spread is no bound's, see PERF.md)."""
    if view.record.plan.kind != "gateway":
        return {}
    lat = view.message_latency_s()
    if lat is None or lat.size == 0:
        return {}
    return {f"p{q}": 1e3 * float(np.quantile(lat, q / 100)) for q in (95, 99)}


def _lateness_p99_ms(record) -> float:
    """How late the sender took the window's messages (p99, ms)."""
    first = record.first_window_message
    if record.messages <= first:
        return 0.0
    late = (np.asarray(record.taken[first:]) - np.asarray(record.due[first:]))
    return 1e3 * float(np.quantile(late, 0.99))


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m swxbench",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_start = process_start()
    args = parse(argv)
    set_cache_dirs()
    try:
        cell = spec.cell(args.workload)
    except spec.SpecError as exc:
        print(f"swxbench: {exc}", file=sys.stderr)
        return EXIT_SPEC
    try:
        import sitewhere_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"swxbench: the port is not in this checkout: {exc}",
              file=sys.stderr)
        return EXIT_NO_PORT
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"swxbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"this host has {torch.cuda.device_count()}", file=sys.stderr)
        return EXIT_NO_CARD
    from swxbench.roofline import device_info

    print(f"swxbench: {cell.name} seed {args.seed} {device_info()}",
          file=sys.stderr, flush=True)
    out = asyncio.run(run_cell(cell, args.seed, args.seconds,
                               bool(args.trace), t_start))
    bad = forbidden_modules()
    if bad:
        print(f"swxbench: loaded {bad}: the run must not use JAX or the "
              f"JAX package", file=sys.stderr)
        return EXIT_JAX
    print(json.dumps(out["notes"]), file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
