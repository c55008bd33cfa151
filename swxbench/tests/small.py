"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
harness's own tests: the same configurations, traffic and checks, with
the fleet, the buckets, the sample and the rate made small. The widths
stay as configured."""

from __future__ import annotations

import asyncio
import copy
import time

from swxbench import spec

DEVICES = 512


def small_cell(name: str, devices: int = DEVICES):
    cell = spec.cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg["devices"] = devices
    rp = cfg["sections"]["rule-processing"]
    rp["buckets"] = [64, 256]
    rp["capacity"] = devices
    cfg["sample_devices"] = 64
    # the flood's receiver queue cut with the fleet: its 1,024 messages of
    # the card's default would hold more than the CPU scores in seconds
    cfg["sections"]["event-sources"] = {"receivers": [
        {"kind": "queue", "name": "default", "maxsize": 8}]}
    traffic = copy.deepcopy(cell.traffic)
    if traffic["kind"] == "flood":
        traffic["warmup_messages"] = 2
    else:
        traffic["rate_events_per_s"] = 10 * devices
        traffic["warmup_messages"] = 16
    cell.config, cell.traffic = cfg, traffic
    return cell


def run_small(name: str, seed: int = 2**31 + 7, seconds: float = 1.0,
              trace: bool = False) -> dict:
    from swxbench.run import run_cell

    return asyncio.run(run_cell(small_cell(name), seed, seconds, trace,
                                time.monotonic(), device="cpu"))
