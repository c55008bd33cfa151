"""The control that a cell's score limit is held against: the plain
reference put in the program's place, its products in the next precision
below the configuration's (`float8_e4m3fn` under bfloat16), its scores
read back in the served dtype, and held against the reference by the
number a run compares (`check.score_gap`).

    python -m swxbench.control --workload <cell> --seeds 1,2,3

For each seed it draws the weights and the traffic as a run does on the
card, takes the run's sampled devices over the messages a run sends (the
count in the cell's limits file: every one accepted, warm-up included),
and prints the control's gap beside the cell's limit. The benchmark's
own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from swxbench import spec

CONTROL_DTYPE = {"bfloat16": "float8_e4m3fn", "float32": "bfloat16"}


def control_gap(cell, seed: int, messages: int, device: str) -> dict:
    import torch

    from swxbench import check
    from swxbench.generator import TrafficPlan

    cfg = cell.config
    ref = cell.reference()
    widths = cfg["widths"]
    plan = TrafficPlan(cell.traffic, cfg["devices"], cfg["warm_ticks"], seed)
    params = ref.make_params(widths, seed, device)
    sample = check.sample_devices(plan.devices, int(cfg["sample_devices"]),
                                  seed)
    served_dtype = getattr(torch, cfg["score_dtype"])
    lower = getattr(torch, cfg["compute_dtype"])
    below = getattr(torch, CONTROL_DTYPE[cfg["compute_dtype"]])
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    gap = 0.0
    try:
        for g in np.unique(sample // plan.slice):
            devs = sample[sample // plan.slice == g]
            msgs = np.arange(g, messages, plan.gateways)
            values = torch.from_numpy(
                check.sent_values(plan, devs, msgs)).to(device)
            want = ref.scores(params, widths, values, plan.warm_ticks,
                              lower).cpu().numpy()
            got = ref.scores(params, widths, values, plan.warm_ticks,
                             below).to(served_dtype).float().cpu().numpy()
            gap = max(gap, check.score_gap(got, want))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return {"workload": cell.name, "seed": seed, "messages": messages,
            "control": str(below).removeprefix("torch."),
            "score_gap": gap,
            "limit": float(cell.limits["score_gap"]["limit"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m swxbench.control",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = spec.cell(args.workload)
    messages = int(cell.limits["score_gap"]["messages"])
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(control_gap(cell, seed, messages, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
