"""The port's bench entry in its other modes, on the CPU: `--split`,
`--workers 2` (with and without `--zombie-drill`), `--ramp`, `--gnn`,
`--train`, `--overload` and the default run under `--chaos`.

Each runs the port's `cli bench --cpu` at a small size (256 devices a
run, windows of a second or less; the GNN at `GNN_SIZES` of 64 and 256)
and holds its report's keys to the keys of the dict literal that the
matching `bench.py` function returns, read with `ast` (nested dict
literals too), with no JAX run. Beside the keys, each run's own
invariants: drains complete, the fleet's drills lose no accepted event,
the zombie's writes fenced and nothing committed twice after, the hog
shed near its quota, chaos counted with the pipeline drained. The
default run and `--replay` are held to a JAX run of `bench.py` in
`tests/test_torch_bench.py`.
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"}


def returned_keys(function: str) -> dict:
    """The keys of the dict literal `bench.py`'s `function` returns:
    {key: nested keys of a dict-literal value, else None}."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    fn = next(n for n in tree.body
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
              and n.name == function)
    def own_returns(node):
        """Returns of `node`'s body, not of the functions it defines."""
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.Return) \
                    and isinstance(child.value, ast.Dict):
                yield child.value
            elif not isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef, ast.Lambda)):
                yield from own_returns(child)

    ret = list(own_returns(fn))

    def keys(d: ast.Dict) -> dict:
        return {k.value: (keys(v) if isinstance(v, ast.Dict) else None)
                for k, v in zip(d.keys, d.values)}

    return keys(ret[-1])


def held_to(report: dict, want: dict, path: str = "") -> None:
    assert set(report) == set(want), (path, set(report) ^ set(want))
    for k, sub in want.items():
        if sub is not None:
            held_to(report[k], sub, f"{path}.{k}")


def bench(*flags: str, timeout: float = 400.0, code: str = None) -> dict:
    cmd = ([sys.executable, "-c", code, *flags] if code else
           [sys.executable, "-m", "sitewhere_tpu_torch.cli", "bench",
            "--cpu", *flags])
    out = subprocess.run(cmd, cwd=REPO, env=ENV, capture_output=True,
                         text=True, timeout=timeout)
    # the error artifact and the traceback first, the log's tail after
    trace = out.stderr[out.stderr.rfind("Traceback"):][-3000:]
    assert out.returncode == 0, (out.stdout[-1000:], trace,
                                 out.stderr[-2000:])
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "error" not in report
    return report


def test_split():
    report = bench("--split", "--devices", "256", "--seconds", "0.5",
                   "--latency-seconds", "0.5")
    held_to(report, returned_keys("run_split_bench"))
    assert report["drain"] == {"saturation_complete": True,
                               "latency_complete": True}
    assert report["value"] > 0 and report["events_scored"] > 0
    assert set(report["p99_breakdown"]) == {"admit", "batch", "device",
                                            "sink"}


@pytest.mark.parametrize("zombie", [False, True], ids=["kill", "zombie"])
def test_workers_2(zombie):
    # the zombie drill SIGSTOPs the busiest worker 30% into a flood of
    # `--seconds`: 3 s leaves it holding in-flight work there (its writes
    # after SIGCONT are what fencing must reject), where 0.3 s into a 1 s
    # flood on a loaded host it could be stopped idle, with no write to
    # fence
    report = bench("--workers", "2", "--devices", "512", "--seconds",
                   "3" if zombie else "1", "--sat-trials", "1",
                   *(["--zombie-drill"] if zombie else []))
    want = returned_keys("run_fleet_bench")
    held_to(report, want)
    fleet = report["fleet"]
    assert fleet["workers"] == 2 and fleet["tenants"] == 4  # max(4, 2N)
    assert all(t["drain_complete"] for t in report["saturation_trials"])
    kill = fleet["kill"]
    assert kill["lost_accepted_events"] == 0
    assert kill["decoded_backlog_after_drain"] == 0
    assert kill["death_detected"] and kill["replacement_spawned"]
    assert fleet["observe"]["workers_reporting"] >= 2
    if zombie:
        z = fleet["zombie"]
        assert z["sigcont_mid_reassignment"]
        assert z["false_positive_death_detected"]
        assert z["fenced_rejections"] >= 1
        assert z["lost_accepted_events"] == 0
        assert z["duplicate_committed_events"] == 0
        assert z["drain_complete"] and z["post_reconverge_drain_complete"]
    else:
        assert fleet["zombie"] is None


def test_ramp():
    report = bench("--ramp", "--devices", "256", "--ramp-seed-seconds", "4",
                   "--ramp-seconds", "6", "--ramp-max-workers", "2")
    held_to(report, returned_keys("run_ramp_bench"))
    ramp = report["ramp"]
    assert ramp["ramp_drain_complete"] and ramp["saturation_rate"] > 0
    assert ramp["good_samples"] > 0
    if ramp["kill"] is not None:  # the autoscaler grew a second worker
        assert ramp["kill"]["lost_accepted_events"] == 0
        assert ramp["kill"]["drain_complete"]


GNN = ("import sys; from sitewhere_tpu_torch.tools import bench; "
       "bench.GNN_SIZES = (64, 256); sys.exit(bench.main(sys.argv[1:]))")


def test_gnn():
    report = bench("--gnn", "--cpu", "--seconds", "0.5", "--window", "16",
                   code=GNN)
    held_to(report, returned_keys("run_gnn_bench"))
    assert set(report["fleet_sizes"]) == {"64", "256"}
    assert report["value"] > 0


def test_train():
    report = bench("--train", "--model", "lstm", "--devices", "64",
                   "--history", "48", "--window", "16")
    held_to(report, returned_keys("run_train_bench"))
    assert report["value"] > 0 and report["steps_per_sec"] > 0


def test_overload():
    report = bench("--overload", "--overload-devices", "128", "--quota",
                   "2000", "--overload-tenants", "2", "--seconds", "1")
    held_to(report, returned_keys("run_overload_bench"))
    # the hog is shed; the well-behaved tenants are not
    assert report["shed_events"]["hog"] > 0
    assert report["accepted"]["hog"] < report["offered"]["hog"]
    for tid in ("good0", "good1"):
        assert report["shed_events"][tid] == 0
        assert report["accepted"][tid] == report["offered"][tid]


def test_chaos():
    report = bench("--chaos", "--chaos-faults", "2", "--devices", "256",
                   "--seconds", "1", "--sat-trials", "1",
                   "--latency-seconds", "0.5")
    held_to(report, returned_keys("run_bench"))
    chaos = report["chaos"]
    assert set(chaos) == {"seed", "sites", "supervisor_restarts",
                          "dead_letters"}
    assert {"bus.poll", "scoring.dispatch"} <= set(chaos["sites"])
    assert report["drain"]["saturation_complete"]
    assert report["drain"]["latency_complete"]
