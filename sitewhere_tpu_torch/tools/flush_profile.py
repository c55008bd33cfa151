"""Where a full-fleet flush spends its time, on the card.

    python -m sitewhere_tpu_torch.tools.flush_profile
        [--path {session,stream,pool,pipeline,replay}] [--model NAME]
        [--flushes N] [--trace FILE]

Builds one of the paths `chip_smoke.py` drives (`tools/main_path.py`,
`tools/pipeline.py`): `session`, the dedicated windowed-`lstm` session
(the default); `stream`, the dedicated `lstm-stream` session; `pool`, the
`lstm-stream` pool with one 32,768-device tenant and one fleet-sized
bucket (the bench's default serving configuration; `--model tft`,
`longwin`, `seasonal` or `lstm` puts that model in the pool instead, at
the width `tools/main_path.MODEL_CFG` gives it); `pipeline`, that
pool inside the service runtime, a "flush" there being one fleet tick
from the tenant's receiver to its last record on the scored topic;
`replay`, the bench's replay workload (`tools/replay_bench.py`), a
"flush" there being one `ReplayEngine` pass over the whole 500,000-event
cold tier through its pool. It warms the path, then runs N full-fleet flushes under `torch.profiler`.
Host spans come from the path's own profiler labels (the session's
`scoring.take_pending`, `scoring.dispatch` and
`scoring.update_and_score` inside it; the pool's
`scoring.pool_take` and `scoring.dispatch`) and a `flush` label put
around each awaited flush here; device spans from the profiler's CUDA
kernel and copy records. Prints the wall time of the flush and the share
of it during which the device was busy (medians over the flushes), and
the host time in each labelled step and the device time by kernel, K1
apart (means per flush). Writes the Chrome trace to FILE (default
`build/flush_trace.json`). Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from sitewhere_tpu_torch.tools import main_path, pipeline

STEPS = {"session": ("flush", "scoring.take_pending", "scoring.dispatch",
                     "scoring.update_and_score"),
         "pool": ("flush", "scoring.pool_take", "scoring.dispatch")}
STEPS["stream"] = STEPS["session"]
STEPS["pipeline"] = STEPS["pool"]
STEPS["replay"] = STEPS["pool"]


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


async def _flusher(which: str, model: str):
    """(one_flush coroutine function, drain) for the chosen path."""
    if which == "pipeline":
        return await _pipeline_flusher()
    if which == "replay":
        return _replay_flusher()
    if which == "pool":
        path = await main_path.build_pool("profile", model, 1,
                                          main_path.FLEET, (main_path.FLEET,))
        drain = path.pool.drain
    else:
        path = main_path.build(
            "profile", "lstm-stream" if which == "stream" else "lstm")
        drain = path.session.drain
    t = path.t

    async def one_flush() -> float:
        nonlocal t
        if which == "pool":
            for tid, tenant in path.tenants.items():
                path.ingest(tid, tenant.sim.tick(t=t)[0])
        else:
            path.ingest(path.sim.tick(t=t)[0])
        t += main_path.TICK_S
        t0 = time.perf_counter()
        with record_function("flush"):
            await (path.flush() if which == "pool" else path.session.flush())
        return 1e3 * (time.perf_counter() - t0)

    return one_flush, drain


async def _pipeline_flusher():
    pipe = await pipeline.build()
    consumer = pipe.scored_consumer()
    t = pipe.t

    async def one_flush() -> float:
        nonlocal t
        payload = pipe.sim.tick(t=t)[0].encode()
        t += pipeline.TICK_S
        t0 = time.perf_counter()
        with record_function("flush"):
            await pipe.receiver.submit(payload)
            await pipeline.collect_scored(consumer, pipeline.FLEET)
        return 1e3 * (time.perf_counter() - t0)

    return one_flush, pipe.stop


def _replay_flusher():
    from sitewhere_tpu_torch.history import ReplayEngine
    from sitewhere_tpu_torch.ops.build import BUILD_ROOT
    from sitewhere_tpu_torch.tools import replay_bench

    # the corpus lives under the checkout's gitignored build/
    BUILD_ROOT.parent.mkdir(parents=True, exist_ok=True)
    root = tempfile.mkdtemp(prefix="replay-profile-", dir=BUILD_ROOT.parent)
    store, _, _, _ = replay_bench.corpus(root)
    pool, model = replay_bench.pool()
    params = model.init(torch.Generator().manual_seed(0))
    engine = ReplayEngine(pool)

    async def one_flush() -> float:
        t0 = time.perf_counter()
        with record_function("flush"):
            await engine.replay(replay_bench.TENANT, store,
                                replay_bench.THRESHOLD, params=params)
        return 1e3 * (time.perf_counter() - t0)

    async def drain() -> None:
        pool.close()
        store.close()
        shutil.rmtree(root, ignore_errors=True)

    return one_flush, drain


async def _run(which: str, model: str, n_flushes: int, trace: Path) -> dict:
    one_flush, drain = await _flusher(which, model)
    steps = STEPS[which]

    for _ in range(2):
        await one_flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = [await one_flush() for _ in range(n_flushes)]
        torch.cuda.synchronize()
    await drain()
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))

    events = prof.events()
    host = {s: [] for s in steps}
    windows, device = [], []
    for e in events:
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CPU and e.name in host:
            host[e.name].append(span[1] - span[0])
            if e.name == "flush":
                windows.append(span)
        elif e.device_type == DeviceType.CUDA and e.name not in host:
            device.append((e.name, span))
    if not device:
        raise SystemExit("flush_profile: the profiler recorded no device time")
    by_kernel: dict[str, float] = {}
    for name, (lo, hi) in device:
        key = ("K1 lstm_window_final" if "lstm_window_final" in name
               else name[:70])
        by_kernel[key] = by_kernel.get(key, 0.0) + (hi - lo) / 1e3
    busy = []
    for lo, hi in windows:
        inside = [(max(a, lo), min(b, hi)) for _, (a, b) in device
                  if b > lo and a < hi]
        busy.append(_union_us(inside) / (hi - lo))
    n = len(windows)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    if which == "replay":
        from sitewhere_tpu_torch.tools.replay_bench import EVENTS as events
    else:
        events = main_path.FLEET
    return {
        "path": which, "model": model if which == "pool" else None,
        "flushes": n, "events_per_flush": events,
        "flush_wall_ms_p50": statistics.median(wall),
        "host_ms_per_flush": {s: sum(v) / 1e3 / n for s, v in host.items()},
        "device_ms_per_flush": sum(by_kernel.values()) / n,
        "device_busy_share_of_flush_p50": statistics.median(busy),
        "device_ms_per_flush_by_kernel": {k: v / n for k, v in top[:12]},
        "device_launches_per_flush": len(device) / n,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(STEPS), default="session")
    ap.add_argument("--model", default="lstm-stream",
                    choices=sorted(main_path.MODEL_CFG),
                    help="the pool's model (--path pool only)")
    ap.add_argument("--flushes", type=int, default=6)
    ap.add_argument("--trace", default="build/flush_trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flush_profile: no CUDA device available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip(), flush=True)
    if args.model != "lstm-stream" and args.path != "pool":
        ap.error("--model applies to --path pool only")
    stats = asyncio.run(_run(args.path, args.model, args.flushes,
                             Path(args.trace)))
    print(json.dumps(stats, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
