"""One traced run of a cell, with the traced stretch split by what the
host had open while the card sat idle, each instant counted once.

    python3 -m swxbench.idle_by_host --workload stream-flood --seed N \
        [--seconds 40]

Prints the run's result line as `python -m swxbench --trace 1` does, with
the end-to-end metrics besides the per-layer ones (a traced run's rate,
for the cost of tracing) and `idle_by_host`: the stretch's length in µs,
the share in % of each category, and the count of each program range.
Each instant of the stretch goes to the first category that holds it:
`device_busy` (a device interval runs), then `gc`, `dispatch`,
`persist`, `settle` (a range of that prefix is open), `other_spans`
(any other range of the program's stages), else `nothing`. The
`idle_in_*` metrics count an instant under every range open at it; here
a collection inside a dispatch counts as `gc` alone.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from swxbench import run, spec
from swxbench.readers.range_share import walk

CATEGORIES = (
    ("gc", ("runtime.gc",)),
    ("dispatch", ("scoring.dispatch",)),
    ("persist", ("event-management.persist",)),
    ("settle", ("scoring.settle",)),
    ("other_spans", ("scoring.", "event-sources.", "inbound.", "egress.",
                     "rule-processing.", "runtime.")),
)


def breakdown(walked) -> dict:
    """The split of one stretch, from `range_share.walk`'s
    `(lo, hi, host, device)`."""
    lo, hi, host, device = walked
    points, counts = [], {}
    for name, a, b in host:
        for i, (_, prefixes) in enumerate(CATEGORIES):
            if name.startswith(prefixes):
                points += [(a, i, 1), (b, i, -1)]
                counts[name] = counts.get(name, 0) + 1
                break
    points += [p for a, b in device for p in ((a, -1, 1), (b, -1, -1))]
    points.append((hi, -1, 0))
    points.sort()
    acc = dict.fromkeys([c for c, _ in CATEGORIES]
                        + ["nothing", "device_busy"], 0.0)
    open_ = [0] * len(CATEGORIES)
    busy, t_prev = 0, lo
    for t, i, d in points:
        if t > t_prev:
            if busy:
                acc["device_busy"] += t - t_prev
            else:
                cat = next((c for (c, _), n in zip(CATEGORIES, open_) if n),
                           "nothing")
                acc[cat] += t - t_prev
            t_prev = t
        if i < 0:
            busy += d
        else:
            open_[i] += d
    length = hi - lo
    return {"stretch_us": length,
            "share_pct": {k: 100.0 * v / length for k, v in acc.items()},
            "ranges": counts}


class _Capture:
    """A per-layer 'metric' that reads no number: it keeps the split of
    the run's stretch."""

    name = "idle_by_host"

    def __init__(self):
        self.got = None

    def read(self, view):
        walked = walk(view)
        if walked is not None:
            self.got = breakdown(walked)
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swxbench.idle_by_host",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)
    t_start = run.process_start()
    run.set_cache_dirs()
    cell = spec.cell(args.workload)
    capture = _Capture()
    cell.per_layer = [*cell.per_layer, *cell.end_to_end, capture]
    out = asyncio.run(run.run_cell(cell, args.seed, args.seconds, True,
                                   t_start))
    out["idle_by_host"] = capture.got
    print(json.dumps(out), flush=True)
    return 0 if out["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
