"""Where a flush of the dedicated scoring session spends its time, on the card.

    python -m sitewhere_tpu_torch.tools.flush_profile [--flushes N] [--trace FILE]

Builds the main path `chip_smoke.py` drives (`tools/main_path.py`),
warms it, then runs N full-fleet flushes under `torch.profiler`. Host
spans come from the session's own profiler labels (`scoring.take_pending`,
`scoring.dispatch`, and `scoring.update_and_score` inside it) and a
`flush` label put around `await session.flush()` here; device spans
from the profiler's CUDA kernel and copy records. Prints the wall time
of the flush and the share of it during which the device was busy
(medians over the flushes), and the host time in each labelled step and
the device time by kernel, K1 apart (means per flush). Writes the Chrome
trace to FILE (default `build/flush_trace.json`). Needs one CUDA
card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from sitewhere_tpu_torch.tools import main_path

STEPS = ("flush", "scoring.take_pending", "scoring.dispatch",
         "scoring.update_and_score")


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


async def _run(n_flushes: int, trace: Path) -> dict:
    path = main_path.build("profile")
    session, t = path.session, path.t

    async def one_flush() -> float:
        nonlocal t
        batch, _ = path.sim.tick(t=t)
        t += main_path.TICK_S
        path.ingest(batch)
        t0 = time.perf_counter()
        with record_function("flush"):
            await session.flush()
        return 1e3 * (time.perf_counter() - t0)

    for _ in range(2):
        await one_flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = [await one_flush() for _ in range(n_flushes)]
        torch.cuda.synchronize()
    await session.drain()
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))

    events = prof.events()
    host = {s: [] for s in STEPS}
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
    return {
        "flushes": n, "events_per_flush": main_path.FLEET,
        "flush_wall_ms_p50": statistics.median(wall),
        "host_ms_per_flush": {s: sum(v) / 1e3 / n for s, v in host.items()},
        "device_ms_per_flush": sum(by_kernel.values()) / n,
        "device_busy_share_of_flush_p50": statistics.median(busy),
        "device_ms_per_flush_by_kernel": {k: v / n for k, v in top[:12]},
        "device_launches_per_flush": len(device) / n,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--flushes", type=int, default=6)
    ap.add_argument("--trace", default="build/flush_trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flush_profile: no CUDA device available")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip(), flush=True)
    stats = asyncio.run(_run(args.flushes, Path(args.trace)))
    print(json.dumps(stats, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
