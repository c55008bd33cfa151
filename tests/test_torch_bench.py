"""The port's bench entry (`sitewhere_tpu_torch/tools/bench.py`, `cli
bench`) on the CPU, against the JAX package's `bench.py`.

- The default run and `--replay`: `bench.py --inner --force-cpu` and the
  port's `cli bench --cpu` on the same flags print reports whose keys are
  equal, recursively, each value of the same type, `lint` included (the
  port's swxlint over the port, no new finding). Maps keyed by what a
  run recorded are held by their rows' shapes (`critical_path`: the
  stage names to the trace registry; `lint.by_code`: the codes found).
- The windowed `lstm` on dedicated sessions (`--model lstm
  --no-megabatch`) scores every accepted event exactly once, and reports
  `pallas: "plain"` (K1's plain version on the CPU).
- No fallback: without `--cpu` on a host with no card the entry exits 1
  with `bench.py`'s error artifact naming the device.
- `--mesh DxM` with `--cpu` shards the pool over D×M logical CPU devices
  and reports what ran; a malformed spec, or one with `--no-megabatch`
  or `--workers`, is a usage error, as in `bench.py`.
- `tools/ab_compare.py fastlane` writes both legs' reports and the table.

The other modes (`--split`, `--workers`, `--ramp`, `--gnn`, `--train`,
`--overload`, `--chaos`) are in `tests/test_torch_bench_modes.py`.
Sizes are small (256 devices, half-second windows).
"""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from sitewhere_tpu_torch.kernel.tracing import TRACE_STAGES
from sitewhere_tpu_torch.tools import bench

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "JAX_PLATFORMS": "cpu"}
SMALL = ["--devices", "256", "--seconds", "0.5", "--sat-trials", "1",
         "--latency-seconds", "0.5"]
# maps whose keys are what the run recorded, not a schema
MAPS = {"critical_path", "by_code"}


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def shape(value, key=None):
    """A report's schema: dict keys (recursively), list element shapes,
    and scalar types (bool apart from int). A map in MAPS is held by its
    rows' shapes only."""
    if isinstance(value, dict):
        if key in MAPS:
            return ("map", sorted({json.dumps(shape(v)) for v in
                                   value.values()}))
        return {k: shape(v, k) for k, v in value.items()}
    if isinstance(value, list):
        return [shape(v) for v in value[:1]]
    return type(value).__name__


def run_jax(flags: list) -> dict:
    out = subprocess.run([sys.executable, "bench.py", "--inner",
                          "--force-cpu", *flags], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return last_json(out.stdout)


def run_port(flags: list) -> tuple[dict, str]:
    out = subprocess.run([sys.executable, "-m", "sitewhere_tpu_torch.cli",
                          "bench", "--cpu", *flags], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return last_json(out.stdout), out.stderr


@pytest.mark.parametrize("flags", [
    pytest.param(SMALL, id="default"),
    pytest.param(["--replay", "--devices", "256", "--replay-events", "4096",
                  "--sat-trials", "1"], id="replay"),
])
def test_report_keys_equal_the_jax_bench(flags):
    want, got = run_jax(flags), run_port(flags)[0]
    assert "error" not in got, got["error"]
    assert got["platform"] == want["platform"] == "cpu"
    assert set(want["lint"]) >= {"new", "baselined"}
    assert "error" not in got["lint"], got["lint"]
    assert got["lint"]["new"] == 0 and got["lint"]["baselined"] > 0
    assert set(got["lint"]["timings_s"]) == set(want["lint"]["timings_s"])
    assert shape(got) == shape(want)
    if "observe" in got:
        assert set(got["observe"]["critical_path"]) <= {
            s for s, _ in TRACE_STAGES}
        assert got["drain"]["saturation_complete"]
        assert got["drain"]["latency_complete"]
        assert got["pallas"] is None and got["mfu"] is None
    else:
        assert all(t["events"] == got["events"] == 4096
                   for t in got["trials"])


def test_windowed_lstm_on_dedicated_sessions_scores_each_event_once(
        monkeypatch, capsys):
    """`--model lstm --no-megabatch`: every event the receivers accepted
    (the warm pass, the saturation trial, the paced window) is on the
    scored topic exactly once, and K1 reports its plain version."""
    from sitewhere_tpu_torch.tools import pipeline as pl

    deploy, phases = pl.deploy, bench._default_phases
    seen = {"accepted": 0, "keys": {}}

    class Counting:
        """A receiver that counts the events it accepted (every payload
        is a whole tick of the tenant's fleet)."""

        def __init__(self, receiver, devices):
            self.receiver, self.devices = receiver, devices

        async def submit(self, payload):
            ok = await self.receiver.submit(payload)
            seen["accepted"] += self.devices if ok else 0
            return ok

    async def deploy_metered(dep):
        pipes = await deploy(dep)
        seen["meters"] = [p.scored_consumer() for p in pipes]
        for p in pipes:
            p.receiver = Counting(p.receiver, p.sim_cfg.num_devices)
        return pipes

    async def phases_then_read(*a, **kw):
        import asyncio

        report = await phases(*a, **kw)
        for _ in range(100):  # the last publishes land on the loop
            for meter in seen["meters"]:
                for rec in meter.poll_nowait(max_records=4096):
                    b = rec.value
                    for key in zip(b.device_index.tolist(), b.ts.tolist()):
                        seen["keys"][key] = seen["keys"].get(key, 0) + 1
            if sum(seen["keys"].values()) >= seen["accepted"]:
                break
            await asyncio.sleep(0.05)
        return report

    monkeypatch.setattr(pl, "deploy", deploy_metered)
    monkeypatch.setattr(bench, "_default_phases", phases_then_read)
    rc = bench.main(["--cpu", "--model", "lstm", "--no-megabatch",
                     "--window", "16", "--history", "64", "--devices", "128",
                     "--seconds", "0.3", "--sat-trials", "1",
                     "--latency-seconds", "0.3"])
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    report = last_json(out)
    assert report["pallas"] == "plain"
    assert report["drain"]["saturation_complete"]
    assert report["drain"]["latency_complete"]
    keys = seen["keys"]
    assert seen["accepted"] > 0
    assert sum(keys.values()) == len(keys) == seen["accepted"]
    assert max(keys.values()) == 1
    kernels = json.loads(next(ln for ln in err.splitlines()
                              if ln.startswith("[bench] kernels "))[16:])
    k1 = kernels["lstm_window_final"]
    assert k1["pallas"] == "plain" and k1["launches"] == 0
    assert k1["dispatches"] > 0


def test_no_card_and_no_cpu_flag_exits_1_with_the_error_artifact(
        monkeypatch, capsys):
    """No fallback: the entry targets the card, and with none it fails at
    start with `bench.py`'s error artifact naming the device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(SMALL) == 1
    report = last_json(capsys.readouterr().out)
    assert report["value"] == 0.0
    assert "no CUDA device" in report["error"]
    assert set(report) == {"metric", "value", "unit", "vs_baseline", "error",
                           "model", "fleet_devices"}
    assert "platform" not in report


def test_cli_bench_without_cpu_on_this_host_exits_1():
    """`cli bench` without `--cpu`, in a fresh process on this host: exit
    1 and the error artifact, never a CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    out = subprocess.run([sys.executable, "-m", "sitewhere_tpu_torch.cli",
                          "bench", *SMALL], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1
    report = last_json(out.stdout)
    assert "no CUDA device" in report["error"]
    assert report["metric"] == "pipeline_scored_events_per_sec"


@pytest.mark.parametrize("bad", [["--mesh", "0x2"], ["--mesh", "ax2"],
                                 ["--mesh", "2x2", "--no-megabatch"],
                                 ["--mesh", "2x2", "--workers", "2"]])
def test_mesh_spec_errors_are_usage_errors(bad):
    with pytest.raises(SystemExit) as exc:
        bench.main([*bad, "--cpu"])
    assert exc.value.code == 2


def test_mesh_reports_the_mesh_that_ran():
    report, _ = run_port([*SMALL, "--tenants", "4", "--mesh", "2x2"])
    assert report["scoring"]["mesh"] == {
        "spec": {"data": 2, "model": 2},
        "shape": {"data": 2, "model": 2}, "devices": 4}
    assert report["scoring"]["megabatch"] is True
    assert report["events_scored"] > 0
    # per-device throughput divides by the devices the dispatch spans
    assert report["model_tflops_per_device"] <= \
        report["model_tflops_median"] / 4 + 1e-5


def test_flags_are_the_jax_bench_flags():
    """Every flag of `bench.py`'s parser (`:2801-3042`), by name and
    default, but the supervisor's (`--probe-only`, `--inner`,
    `--probe-horizon`) and `--force-cpu` (the port's `--cpu`)."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    want = {}
    for call in ast.walk(main):
        if isinstance(call, ast.Call) and getattr(
                call.func, "attr", None) == "add_argument":
            name = call.args[0].value
            kw = {k.arg: k.value for k in call.keywords}
            want[name] = (ast.literal_eval(kw["default"])
                          if "default" in kw else None)
    dropped = {"--probe-only", "--inner", "--probe-horizon", "--force-cpu"}
    got = {a.option_strings[0]: a.default
           for a in bench.parser()._actions if a.option_strings
           and a.option_strings[0] != "-h"}
    assert set(want) - dropped == set(got) - {"--cpu"}
    for name in set(want) - dropped:
        if want[name] is not None:
            assert got[name] == want[name], name


def test_ab_compare_fastlane_writes_both_reports(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "sitewhere_tpu_torch.tools.ab_compare",
         "fastlane", "--prefix", str(tmp_path / "fastlane"), "--", "--cpu",
         *SMALL], cwd=REPO, env=ENV, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    off = json.loads((tmp_path / "fastlane_off.json").read_text())
    on = json.loads((tmp_path / "fastlane_on.json").read_text())
    assert off["fastlane"] == "off" and off["hops"] == 3
    assert on["fastlane"] == "on" and on["hops"] == 1
    assert "| fastlane off | fastlane on |" in out.stdout
