"""The port's swxlint (`sitewhere_tpu_torch/analysis/`) against the JAX
package's (`sitewhere_tpu/analysis/`).

- Every fixture of `tests/test_analysis.py` runs as one case here, with
  the engine calls routed through both linters: the sources go to the
  JAX engine as written and to the port's with the package prefix
  `sitewhere_tpu` → `sitewhere_tpu_torch` (paths, imports, baseline
  keys). The findings, baselined and suppressed findings, stale and
  undocumented baseline entries must agree code for code and line for
  line, and the fixture's own assertions then run on the JAX report.
  The fixtures that build the engine's `Module`/`Project`/`Baseline`
  directly (the dataflow layer, the baseline file) and the registry
  check run on the port's classes and registry instead.
- The port's tree is lint-clean modulo its own baseline
  (`analysis/baseline.json`), every entry with a reason, and `python -m
  sitewhere_tpu_torch.analysis` / `cli lint` exit 0 clean, 1 on new
  findings, 2 on a usage error.
- The triage's two port findings: the fleet worker's control loop
  commits its handled-through frontier when it is cancelled mid-batch
  (CAN01, a port fault: the JAX loop replays the batch), and the
  registry replay's poll loop (DLQ01, baselined) skips a value that is
  not a dict and fails on a state record it cannot read, as the JAX
  replay does.
"""

import asyncio
import importlib
import inspect
import json
import re
import subprocess
import sys
import types

import pytest
import torch

import sitewhere_tpu.analysis.engine as jax_engine
import sitewhere_tpu_torch.analysis.engine as port_engine
from sitewhere_tpu_torch.analysis import registry as port_registry
from sitewhere_tpu_torch.analysis.__main__ import main as lint_main
from tests import test_analysis as ref

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

REPO = str(__import__("pathlib").Path(__file__).resolve().parents[1])
_PREFIX = re.compile(r"\bsitewhere_tpu\b(?!_torch)")


def port_text(text: str) -> str:
    return _PREFIX.sub("sitewhere_tpu_torch", text)


def jax_text(text: str) -> str:
    return text.replace("sitewhere_tpu_torch", "sitewhere_tpu")


def _baselines(bl) -> tuple:
    """(the JAX engine's Baseline, the port's) from a fixture's baseline,
    keyed by the JAX package's paths."""
    if bl is None:
        return None, None
    out = []
    for cls, conv in ((jax_engine.Baseline, jax_text),
                      (port_engine.Baseline, port_text)):
        out.append(cls(
            entries={(conv(p), c, q): r for (p, c, q), r in bl.entries.items()},
            since={(conv(p), c, q): s for (p, c, q), s in bl.since.items()},
            undocumented=[{**e, "path": conv(e.get("path", ""))}
                          for e in bl.undocumented]))
    return tuple(out)


def _rows(findings) -> list:
    return sorted((jax_text(f.path), f.line, f.code, f.qualname,
                   jax_text(f.message), jax_text(f.hint)) for f in findings)


def _entries(entries) -> list:
    return sorted(json.dumps({**e, "path": jax_text(e.get("path", ""))},
                             sort_keys=True) for e in entries)


def dual_lint_sources(sources, baseline=None, checkers=None):
    """`lint_sources` through both engines, held equal; returns the JAX
    report (the fixture's assertions read it)."""
    jax_bl, port_bl = _baselines(baseline)
    jax_checkers = port_checkers = None
    if checkers is not None:
        jax_checkers = [getattr(inspect.getmodule(c), c.__name__)
                        for c in checkers]
        port_checkers = [getattr(importlib.import_module(
            port_text(c.__module__)), c.__name__) for c in checkers]
    want = jax_engine.lint_sources(
        {jax_text(p): jax_text(s) for p, s in sources.items()},
        baseline=jax_bl, checkers=jax_checkers)
    got = port_engine.lint_sources(
        {port_text(p): port_text(s) for p, s in sources.items()},
        baseline=port_bl, checkers=port_checkers)
    assert _rows(got.findings) == _rows(want.findings)
    assert _rows(f for f, _ in got.baselined) == \
        _rows(f for f, _ in want.baselined)
    assert sorted(r for _, r in got.baselined) == \
        sorted(r for _, r in want.baselined)
    assert _rows(got.suppressed) == _rows(want.suppressed)
    assert _entries(got.stale_baseline) == _entries(want.stale_baseline)
    assert _entries(got.undocumented_baseline) == \
        _entries(want.undocumented_baseline)
    assert got.exit_code == want.exit_code
    assert got.checked_files == want.checked_files
    assert set(got.timings) == set(want.timings)
    assert got.counts() == want.counts()
    return want


# the fixtures that read the live tree, the CLI or the JAX runtime: the
# port's counterparts are the tests below
_OWN = {
    "test_live_codebase_is_lint_clean_modulo_baseline",
    "test_cli_json_report",
    "test_swx_lint_subcommand",
    "test_cli_exit_nonzero_on_findings",
    "test_fault_injector_arm_warns_on_unregistered_site",
}
FIXTURES = sorted(name for name, fn in vars(ref).items()
                  if name.startswith("test_") and callable(fn)
                  and name not in _OWN)


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_agrees_with_the_jax_engine(name, request, monkeypatch):
    monkeypatch.setattr(ref, "lint_sources", dual_lint_sources)
    # direct uses of the engine's classes and the registry: the port's
    for attr in ("Module", "Project", "Baseline", "Finding"):
        monkeypatch.setattr(ref, attr, getattr(port_engine, attr))
    for attr in ("FAULT_SITES", "METRICS", "COUNTERS", "GAUGES", "METERS",
                 "HISTOGRAMS"):
        monkeypatch.setattr(ref, attr, getattr(port_registry, attr))
    fn = getattr(ref, name)
    fn(**{p: request.getfixturevalue(p)
          for p in inspect.signature(fn).parameters})


def test_every_jax_fixture_is_a_case_here():
    cases = {n for n, f in vars(ref).items()
             if n.startswith("test_") and callable(f)}
    assert cases == set(FIXTURES) | _OWN
    assert len(FIXTURES) >= 70


# -- the port's live tree and its CLI ----------------------------------------


def test_live_port_is_lint_clean_modulo_its_baseline():
    report = port_engine.lint_package()
    assert report.findings == [], "\n" + "\n".join(
        f.render() for f in report.findings)
    assert report.stale_baseline == [], report.stale_baseline
    assert report.undocumented_baseline == []
    assert report.baselined
    assert all(reason.strip() for _, reason in report.baselined)
    # the port's baseline is its own file; the JAX package's stays put
    assert port_engine.default_baseline_path() == \
        port_engine.package_root() / "analysis" / "baseline.json"
    assert all(f.path.startswith("sitewhere_tpu_torch/")
               for f, _ in report.baselined)


def test_registry_is_the_ports_one_source_of_truth():
    from sitewhere_tpu_torch.kernel import faults, tracing

    assert faults.FAULT_SITES is port_registry.FAULT_SITES
    assert tracing.TRACE_STAGES is port_registry.TRACE_STAGES
    for name in ("scoring.mesh_devices", "scoring.mesh_row_occupancy",
                 "scoring.model_tflops_per_device"):
        assert port_registry.METRICS[name] == "gauge"
    assert "scoring.mesh" in port_registry.FAULT_SITES


def test_fault_injector_arm_warns_on_unregistered_site(caplog):
    import logging

    from sitewhere_tpu_torch.kernel.faults import FaultInjector

    fi = FaultInjector(seed=1)
    with caplog.at_level(logging.WARNING,
                         logger="sitewhere_tpu_torch.kernel.faults"):
        fi.arm("bus.poll")
        assert not caplog.records
        fi.arm("no.such.site")
    assert any("no.such.site" in r.getMessage() for r in caplog.records)


def test_cli_json_report(capsys):
    rc = lint_main(["--format", "json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0 and out["clean"] is True
    assert out["checked_files"] > 100
    assert out["findings"] == []
    assert set(out["timings_s"]) == set(port_engine.CHECKER_CODES.values())
    assert all(t >= 0 for t in out["timings_s"].values())


def _bad_package(tmp_path):
    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "mod.py").write_text(
        "import time\n\nasync def f():\n    time.sleep(1)\n")
    return bad


@pytest.mark.parametrize("how", ["module", "cli"])
def test_exit_codes_0_1_2(how, tmp_path):
    cmd = ([sys.executable, "-m", "sitewhere_tpu_torch.analysis"]
           if how == "module" else
           [sys.executable, "-m", "sitewhere_tpu_torch.cli", "lint"])
    bad = _bad_package(tmp_path)

    def run(*args):
        return subprocess.run([*cmd, *args], cwd=REPO, capture_output=True,
                              text=True, timeout=120)

    clean = run("--format", "json")
    assert clean.returncode == 0, clean.stderr
    assert json.loads(clean.stdout)["clean"] is True
    dirty = run("--root", str(bad), "--format", "json",
                "--baseline", str(tmp_path / "none.json"))
    assert dirty.returncode == 1
    assert json.loads(dirty.stdout)["findings"][0]["code"] == "ASY01"
    assert run("--root", str(tmp_path / "missing")).returncode == 2
    assert run("--format", "yaml").returncode == 2


def test_write_baseline_then_clean(tmp_path, capsys):
    bad = _bad_package(tmp_path)
    bl = tmp_path / "bl.json"
    assert lint_main(["--root", str(bad), "--baseline", str(bl),
                      "--write-baseline"]) == 0
    doc = json.loads(bl.read_text())
    assert [e["code"] for e in doc["entries"]] == ["ASY01"]
    # an entry without a reason mutes nothing
    assert lint_main(["--root", str(bad), "--baseline", str(bl)]) == 1
    doc["entries"][0]["reason"] = "fixture: documented"
    bl.write_text(json.dumps(doc))
    assert lint_main(["--root", str(bad), "--baseline", str(bl)]) == 0
    capsys.readouterr()


def test_dump_registry_lists_only_registered_names(capsys):
    assert lint_main(["--dump-registry"]) == 0
    inv = json.loads(capsys.readouterr().out)
    assert set(inv["fault_sites"]) <= port_registry.FAULT_SITES
    assert "scoring.mesh" in inv["fault_sites"]
    for name, kinds in inv["metrics"].items():
        assert kinds == [port_registry.METRICS[name]], name


# -- the triage's port findings ----------------------------------------------


def _control_loop_replays(pkg: str, monkeypatch) -> list:
    """Run the fleet worker's control loop of `pkg` over records
    ["a", "poison", "b"], cancel it while it quarantines the poison
    record, run a fresh loop on the same group, and return what
    `handle_control` applied."""
    worker_mod = __import__(f"{pkg}.fleet.worker", fromlist=["_"])
    bus_mod = __import__(f"{pkg}.kernel.bus", fromlist=["_"])
    metrics_mod = __import__(f"{pkg}.kernel.metrics", fromlist=["_"])
    gate = asyncio.Event()
    quarantining = asyncio.Event()

    async def slow_quarantine(*args, **kwargs):
        quarantining.set()
        await gate.wait()

    monkeypatch.setattr(worker_mod.dlq, "quarantine", slow_quarantine)

    class Worker:
        worker_id = "w0"
        control_topic = "swx.instance.fleet-control"
        heartbeat_s = 60.0

        def __init__(self, rt):
            self.runtime = rt
            self.applied = []

        async def heartbeat(self):
            pass

        def handle_control(self, value):
            if value == "poison":
                raise ValueError("poison control record")
            self.applied.append(value)

    async def main():
        bus = bus_mod.EventBus(default_partitions=1)
        rt = types.SimpleNamespace(
            bus=bus, naming=bus_mod.TopicNaming("swx"), faults=None,
            metrics=metrics_mod.MetricsRegistry())
        w = Worker(rt)
        for v in ("a", "poison", "b"):
            await bus.produce(w.control_topic, v)
        task = asyncio.create_task(worker_mod._WorkerControlLoop(w)._run())
        await asyncio.wait_for(quarantining.wait(), 10)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        gate.set()
        task = asyncio.create_task(worker_mod._WorkerControlLoop(w)._run())
        deadline = asyncio.get_running_loop().time() + 10
        while "b" not in w.applied:
            assert asyncio.get_running_loop().time() < deadline, w.applied
            await asyncio.sleep(0.01)
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            await task
        return w.applied

    return asyncio.run(main())


def test_worker_control_loop_commits_its_handled_frontier(monkeypatch):
    # the JAX loop commits once a batch: a cancellation mid-batch
    # replays "a" (its baseline: re-applying is a no-op there)
    assert _control_loop_replays("sitewhere_tpu", monkeypatch) == \
        ["a", "a", "b"]
    # the port's loop re-applies nothing it handled: re-applying a
    # placement at the live epoch marks evicted tenants there
    assert _control_loop_replays("sitewhere_tpu_torch", monkeypatch) == \
        ["a", "b"]


class _ReplayBus:
    """A bus without `peek` (as the wire bus): the replay reads it
    through a consumer group."""

    def __init__(self, values):
        self.values = list(values)

    def end_offsets(self, topic):
        return [len(self.values)]

    def subscribe(self, topic, *, group, name):
        bus = self

        class Consumer:
            pos = 0

            def seek_to_beginning(self):
                self.pos = 0

            async def poll(self, max_records=512, timeout=0.3):
                out = [types.SimpleNamespace(value=v, offset=i, partition=0)
                       for i, v in enumerate(bus.values)][self.pos:]
                self.pos = len(bus.values)
                return out

            def close(self):
                pass

        return Consumer()


@pytest.mark.parametrize("pkg", ["sitewhere_tpu", "sitewhere_tpu_torch"])
def test_registry_replay_skips_non_dicts_and_fails_on_a_bad_record(pkg):
    replication = __import__(f"{pkg}.services.replication", fromlist=["_"])
    bus_mod = __import__(f"{pkg}.kernel.bus", fromlist=["_"])

    def replay(values):
        rt = types.SimpleNamespace(bus=_ReplayBus(values),
                                   naming=bus_mod.TopicNaming("swx"))
        return asyncio.run(replication.read_state_topic(rt, "t0"))

    snap = {"kind": "snap", "seq": 3}
    mut = {"kind": "mut", "seq": 4}
    # poison that is not a state record is skipped
    assert replay([b"\x00garbage", snap, None, mut]) == (snap, [mut])
    # a state record the decode cannot read fails the replay (and so
    # the adopting engine's start) instead of restoring without it
    with pytest.raises(ValueError):
        replay([snap, {"kind": "mut", "seq": "not-a-number"}])
