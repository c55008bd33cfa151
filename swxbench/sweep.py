"""Find a gateway mix's knee: the highest rate the deployment sustains
without a growing backlog.

    python -m swxbench.sweep --config <config> --traffic <gateway mix>
        --rates 400000,800000,... [--seconds 8] [--seed N]

One process, one deployment of the configuration on the CUDA card; the
mix runs at each rate in turn (its `rate_events_per_s` replaced), each a
warm-up, a window of `--seconds` and a drain. A rate's line reports what
was offered and completed, the message latencies from due time (p50,
p99), how late the sender ran, the rejections, and the backlog's growth:
the median latency of the window's last quarter of messages over its
first quarter's. A rate is sustained when nothing was rejected, the
window drained, and the last quarter's median stays within twice the
first's plus one batch window (the backlog did not grow). The knee is the
highest sustained rate below the first that is not; a paced cell runs at
four fifths of it. Prints one JSON line a rate and a last line with the
knee.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import sys
import time

import numpy as np

from swxbench import spec

GROWTH_SLACK_S = 0.002


def _quarter_medians(lat: np.ndarray) -> tuple[float, float]:
    q = max(lat.size // 4, 1)
    return float(np.median(lat[:q])), float(np.median(lat[-q:]))


async def sweep(config: dict, mix: dict, rates: list[float], seconds: float,
                seed: int) -> list[dict]:
    import torch

    from swxbench import check
    from swxbench.deploy import deploy
    from swxbench.generator import TrafficPlan
    from swxbench.run import RunView
    from swxbench.window import run as run_window

    ref = importlib.import_module(f"swxbench.reference.{config['reference']}")
    widths = config["widths"]
    base = TrafficPlan({**mix, "rate_events_per_s": rates[0]},
                       config["devices"], config["warm_ticks"], seed)
    params = ref.make_params(widths, seed, "cuda")
    dep = await deploy(config, base.warm, base.tick_s, params,
                       config["instance"]["trace_sample"])
    rows = []
    try:
        for step, rate in enumerate(rates):
            plan = TrafficPlan({**mix, "rate_events_per_s": rate},
                               config["devices"], config["warm_ticks"],
                               seed + step)
            # time stamps of their own: no record of an earlier step is
            # read as this one's
            plan.t0 += 1e7 * (step + 1)
            plan.prefill(seconds)
            t = time.monotonic()
            record = await run_window(dep, plan, seconds)
            scored = check.flatten(record)
            view = RunView(record, scored, None, None, 0.0, widths, 0.0, True)
            lat = view.message_latency_s()
            arrival = scored.arrival
            done = int(((arrival >= record.t_window0)
                        & (arrival < record.t_window1)).sum())
            finite = lat[np.isfinite(lat)]
            first, last = (_quarter_medians(finite) if finite.size
                           else (float("inf"), float("inf")))
            late = (np.asarray(record.taken[record.first_window_message:])
                    - np.asarray(record.due[record.first_window_message:]))
            window_ms = float(config["sections"]["rule-processing"]
                              ["batch_window_ms"]) / 1e3
            row = {
                "rate": rate,
                "completed_events_per_s": done / record.window_s,
                "messages": int(lat.size),
                "p50_ms": 1e3 * float(np.quantile(lat, 0.5)),
                "p99_ms": 1e3 * float(np.quantile(lat, 0.99)),
                "first_quarter_p50_ms": 1e3 * first,
                "last_quarter_p50_ms": 1e3 * last,
                "late_p99_ms": 1e3 * float(np.quantile(late, 0.99)),
                "rejections": record.rejections,
                "drained": record.drained,
                "drain_s": record.t_drained - record.t_window1,
                "step_s": time.monotonic() - t,
            }
            row["sustained"] = bool(
                record.rejections == 0 and record.drained
                and np.isfinite(last)
                and last <= 2.0 * first + max(GROWTH_SLACK_S, window_ms))
            rows.append(row)
            print(json.dumps(row), flush=True)
            del record, scored, view
            torch.cuda.synchronize()
    finally:
        await dep.stop()
    return rows


def knee(rows: list[dict]) -> float | None:
    best = None
    for row in sorted(rows, key=lambda r: r["rate"]):
        if not row["sustained"]:
            break
        best = row["rate"]
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swxbench.sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    from swxbench.run import set_cache_dirs

    set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("swxbench.sweep: no CUDA card", file=sys.stderr)
        return 3
    bench = spec.benchmark()
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = json.loads((spec.ROOT / files[args.config]).read_text())
    mix = json.loads((spec.PKG / "traffic"
                      / f"{args.traffic}.json").read_text())
    rates = [float(r) for r in args.rates.split(",")]
    rows = asyncio.run(sweep(config, mix, rates, args.seconds, args.seed))
    k = knee(rows)
    print(json.dumps({"config": args.config, "knee_events_per_s": k,
                      "paced_rate": None if k is None else 0.8 * k}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
