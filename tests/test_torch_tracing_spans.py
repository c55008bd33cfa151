"""The port tracer's span write path (`Tracer.span`), its host stages,
the garbage-collection hook the service runtime installs, the raw-sample
quantiles of `stage_summary`, and the benchmark's readers of the host
ranges (`swxbench/readers/range_share.py`, `idle_under_range.py`), on
synthetic profiler events. CPU only."""

import asyncio
import gc
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from sitewhere_tpu_torch.analysis import engine as port_engine
from sitewhere_tpu_torch.analysis import registry
from sitewhere_tpu_torch.config import InstanceSettings
from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.kernel import tracing
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.kernel.service import ServiceRuntime
from sitewhere_tpu_torch.kernel.tracing import (
    NULL_TRACER,
    Tracer,
    merge_stage_exports,
)
from swxbench import idle_by_host
from swxbench.readers import idle_under_range, range_share
from swxbench.trace import MARK

torch.set_num_threads(2)


# -- the write path ------------------------------------------------------------

def test_host_stage_records_whatever_the_sampling():
    tr = Tracer(sample=64)
    with tr.span("scoring.dispatch", n_events=5) as sp:
        time.sleep(0.001)
    [got] = tr.spans(stage="scoring.dispatch")
    assert (got.trace_id, got.tenant_id, got.n_events) == (0, "", 5)
    assert got.t_start == sp.t_start
    assert got.duration_s >= 0.001
    for _ in range(3):
        with tr.span("scoring.settle"):
            pass
    assert len(tr.spans(stage="scoring.settle")) == 3


def test_per_trace_stage_records_only_when_sampled():
    tr = Tracer(sample=64)
    for trace_id in (0, 63, 65):
        with tr.span("event-management.persist", "t", trace_id, 8):
            pass
    assert tr.spans(stage="event-management.persist") == []
    with tr.span("event-management.persist", "t", 128) as sp:
        sp.n_events = 12   # known only inside the block
    [got] = tr.spans(stage="event-management.persist")
    assert (got.trace_id, got.tenant_id, got.n_events) == (128, "t", 12)


def test_a_block_that_raises_records_no_span():
    tr = Tracer(sample=1)
    with pytest.raises(ValueError):
        with tr.span("scoring.dispatch"):
            raise ValueError("dispatch failed")
    assert tr.spans(stage="scoring.dispatch") == []


def test_record_keeps_the_modulo_sampling_for_trace_stages():
    tr = Tracer(sample=4)
    tr.record(3, "rule-processing.dispatch", "t", 1.0, 0.5, 2)
    tr.record(0, "runtime.gc.full", "", 1.0, 0.5, 9)
    tr.record(8, "rule-processing.dispatch", "t", 2.0, 0.5, 2)
    assert [s.trace_id for s in tr.spans(limit=-1)] == [8, 0]


def test_null_tracer_keeps_nothing():
    with NULL_TRACER.span("scoring.dispatch"):
        pass
    NULL_TRACER.record(64, "rule-processing.score", "t", 1.0, 0.1, 1)
    assert NULL_TRACER.spans(limit=-1) == []


# -- the profiler ---------------------------------------------------------------

def _ranges(prof, name):
    return [e for e in prof.events() if e.name == name]


def test_span_is_a_profiler_range_of_the_same_length():
    tr = Tracer(sample=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):   # the first range pays for warming up
            with tr.span("scoring.pool_take"):
                time.sleep(0.001)
        with tr.span("scoring.settle"):
            time.sleep(0.003)
    [rng] = _ranges(prof, "scoring.settle")
    [span] = tr.spans(stage="scoring.settle")
    assert abs(rng.time_range.elapsed_us() - span.duration_s * 1e6) < 50.0
    assert len(_ranges(prof, "scoring.pool_take")) == 3


def test_no_range_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    assert tracing.profiler_range("scoring.dispatch") is None
    with NULL_TRACER.span("scoring.dispatch") as sp:
        assert sp._range is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a null tracer's spans are still ranges (tools with no runtime)
        with NULL_TRACER.span("scoring.dispatch") as sp:
            assert sp._range is not None
    assert len(_ranges(prof, "scoring.dispatch")) == 1


# -- garbage collections ---------------------------------------------------------

def _hooks() -> int:
    return gc.callbacks.count(tracing._on_gc)


@pytest.fixture
def lone_hook(monkeypatch):
    """The process's hook as if no runtime of another test were left
    started in this worker."""
    monkeypatch.setattr(tracing, "_gc_watches", ())
    kept = _hooks()
    for _ in range(kept):
        gc.callbacks.remove(tracing._on_gc)
    yield
    while tracing._on_gc in gc.callbacks:
        gc.callbacks.remove(tracing._on_gc)
    gc.callbacks.extend([tracing._on_gc] * kept)


def _full(rt) -> int:
    return len(rt.tracer.spans(stage="runtime.gc.full"))


def test_forced_collection_in_a_started_runtime(run, lone_hook):
    async def main():
        rt = ServiceRuntime(InstanceSettings(device="cpu"))
        await rt.start()
        try:
            gen2 = rt.metrics.counter("runtime.gc_collections:gen2").value
            pauses = rt.metrics.histogram("runtime.gc_pause_s").count
            garbage = [[]]
            garbage[0].append(garbage)   # a cycle only a collection frees
            del garbage
            gc.collect()
            span = rt.tracer.spans(stage="runtime.gc.full")[0]
            assert span.trace_id == 0 and span.n_events >= 2
            assert span.duration_s > 0
            assert rt.metrics.counter(
                "runtime.gc_collections:gen2").value >= gen2 + 1
            pause = rt.metrics.histogram("runtime.gc_pause_s")
            assert pause.count >= pauses + 1
            assert pause.buckets[-1] >= 1.0
            gc.collect(0)
            assert rt.metrics.counter(
                "runtime.gc_collections:gen0").value >= 1
            # young collections are no ring spans
            assert rt.tracer.stages() == ["runtime.gc.full"]
        finally:
            await rt.stop()

    run(main())


def test_collections_are_profiler_ranges(run, lone_hook):
    async def main():
        rt = ServiceRuntime(InstanceSettings(device="cpu"))
        await rt.start()
        try:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                gc.collect()
                gc.collect(0)
            assert len(_ranges(prof, "runtime.gc.full")) >= 1
            assert len(_ranges(prof, "runtime.gc.young")) >= 1
        finally:
            await rt.stop()

    run(main())


def test_two_runtimes_install_one_hook(run, lone_hook):
    async def main():
        assert _hooks() == 0
        a = ServiceRuntime(InstanceSettings(device="cpu", instance_id="a"))
        b = ServiceRuntime(InstanceSettings(device="cpu", instance_id="b"))
        await a.start()
        await b.start()
        assert _hooks() == 1
        n_a, n_b = _full(a), _full(b)
        gc.collect()
        assert _full(a) > n_a and _full(b) > n_b
        for rt in (a, b):
            assert rt.metrics.counter(
                "runtime.gc_collections:gen2").value >= 1
        await a.stop()
        assert _hooks() == 1
        n_a, n_b = _full(a), _full(b)
        gc.collect()
        assert _full(a) == n_a and _full(b) > n_b
        await b.stop()
        assert _hooks() == 0

    run(main())


def test_a_runtime_dropped_unstopped_leaves_no_live_watcher(lone_hook):
    kept = Tracer(sample=1)
    keep = tracing.watch_gc(kept, MetricsRegistry())
    lost = Tracer(sample=1)
    tracing.watch_gc(lost, MetricsRegistry())   # never unwatched
    del lost
    gc.collect()   # frees the tracer; the hook skips its dead watcher
    assert len(tracing._gc_watches) == 2
    assert len(kept.spans(stage="runtime.gc.full")) >= 1
    other = tracing.watch_gc(Tracer(sample=1), MetricsRegistry())
    assert tracing._gc_watches == (keep, other)   # the dead one pruned
    tracing.unwatch_gc(keep)
    tracing.unwatch_gc(other)
    assert _hooks() == 0


# -- the queue/service split and the quantiles ---------------------------------

def _traced(tr: Tracer) -> None:
    for k, (stage, ms) in enumerate([("event-sources.decode", 0.2),
                                     ("rule-processing.dispatch", 3.0),
                                     ("rule-processing.score", 1.5),
                                     ("egress.publish", 0.1)] * 5):
        tr.record(64 * (k + 1), stage, "t", float(k), ms * (1 + k) / 1e3, 4)


def test_critical_path_is_unchanged_by_host_stages():
    tr = Tracer(sample=64)
    _traced(tr)
    want = tr.critical_path()
    export = tr.stage_export()
    with tr.span("scoring.dispatch", n_events=3):
        time.sleep(0.002)
    tr.record(0, "runtime.gc.full", "", 5.0, 0.25, 1000)
    assert tr.critical_path() == want
    assert merge_stage_exports([tr.stage_export()]) == \
        merge_stage_exports([export])
    # the dashboard still lists them
    assert {"scoring.dispatch", "runtime.gc.full"} <= set(tr.stage_summary())


def test_stage_summary_quantiles_are_the_raw_durations():
    tr = Tracer(sample=1, stage_capacity=256)
    for ms in range(1, 101):
        tr.record(ms, "inbound.enrich", "t", float(ms), ms / 1e3, 1)
    row = tr.stage_summary()["inbound.enrich"]
    want = np.quantile(np.arange(1, 101, dtype=np.float64), [0.5, 0.95, 0.99])
    assert [row["p50_ms"], row["p95_ms"], row["p99_ms"]] == \
        [round(float(q), 3) for q in want]
    assert row["p99_ms"] == 99.01          # no bucket edge (81.92, 163.84)
    assert (row["count"], row["max_ms"], row["mean_ms"]) == (100, 100.0, 50.5)


def test_host_stages_are_registered_as_host():
    host = {name for name, kind in registry.TRACE_STAGES if kind == "host"}
    assert host == registry.HOST_STAGES == {
        "scoring.pool_take", "scoring.take_pending", "scoring.dispatch",
        "scoring.update_and_score", "scoring.settle", "runtime.gc.full",
        "runtime.gc.young", "tft.select", "tft.seq2seq", "tft.attend"}
    assert registry.METRICS["runtime.gc_collections"] == "counter"
    assert registry.METRICS["runtime.gc_pause_s"] == "histogram"


# -- the linter -------------------------------------------------------------------

def test_trc01_and_met01_pass_over_the_tree():
    report = port_engine.lint_package()
    assert [f for f in report.findings if f.code in ("TRC01", "MET01")] == []


@pytest.mark.parametrize("call, finds", [
    ('with self.tracer.span("scoring.settle"):\n            pass', False),
    ('with self.tracer.span("scoring.setle"):\n            pass', True),
    ('with self.tracer.span(name):\n            pass', True),
    ('self.tracer.record(1, "runtime.gc.full", "", 0.0, 0.0)', False),
])
def test_trc01_resolves_span_stage_literals(call, finds):
    src = ("class Pool:\n"
           "    def flush(self, name):\n"
           f"        {call}\n")
    report = port_engine.lint_sources(
        {"sitewhere_tpu_torch/scoring/fixture.py": src})
    assert any(f.code == "TRC01" for f in report.findings) is finds


def test_trc01_parity_accepts_a_span():
    src = ("class Persister:\n"
           "    def persist(self, spi, batch):\n"
           "        with self.tracer.span(\"event-management.persist\"):\n"
           "            spi.add_measurements(batch)\n"
           "    def bare(self, spi, batch):\n"
           "        spi.add_measurements(batch)\n")
    report = port_engine.lint_sources(
        {"sitewhere_tpu_torch/services/event_management.py": src})
    assert [f.qualname for f in report.findings if f.code == "TRC01"] == \
        ["Persister.bare"]


def test_no_span_block_of_the_port_awaits():
    """A profiler range open across an await would time whatever other
    coroutines ran meanwhile: stages whose work awaits keep `record()`."""
    import ast
    from pathlib import Path

    root = Path(tracing.__file__).resolve().parents[1]
    blocks = awaiting = 0
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            for item in node.items:
                call = item.context_expr
                if (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "span"):
                    blocks += 1
                    awaiting += any(isinstance(n, ast.Await)
                                    for b in node.body for n in ast.walk(b))
    assert blocks >= 10 and awaiting == 0


# -- the pool's host spans --------------------------------------------------------

def test_pool_records_take_dispatch_and_settle(run):
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
    from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool

    async def main():
        tr = Tracer(sample=64)
        pool = SharedScoringPool(
            build_model("zscore", device="cpu", window=16), MetricsRegistry(),
            PoolConfig(batch_buckets=(16,), batch_window_ms=1.0),
            tracer=tr, device="cpu")
        store = TelemetryStore(history=32, initial_devices=8)
        got = []

        async def deliver(scored):
            got.append(scored)

        pool.register("t", store, 4.0, deliver)
        deadline = time.monotonic() + 30.0
        while not pool.ready and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        pool.admit("t", MeasurementBatch(
            BatchContext(tenant_id="t", source="s"),
            np.arange(8, dtype=np.uint32), np.zeros(8, np.uint16),
            np.full(8, 21.0, np.float32), np.full(8, 10.0)))
        while not got and time.monotonic() < deadline:
            await asyncio.sleep(0.01)
        pool.close()
        assert len(got) == 1
        for stage in ("scoring.pool_take", "scoring.dispatch",
                      "scoring.settle"):
            spans = tr.spans(stage=stage)
            assert spans and all(s.trace_id == 0 for s in spans), stage
        assert tr.spans(stage="scoring.dispatch")[0].n_events == 8
        assert tr.spans(stage="scoring.settle")[0].n_events == 8

    run(main())


# -- the benchmark's readers, on synthetic events -----------------------------------

def _event(name, lo, hi, device=DeviceType.CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=lo, end=hi))


def _run(events, on_card=True):
    prof = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(stretch=SimpleNamespace(prof=prof),
                           on_card=on_card)


STRETCH = _event(MARK, 0.0, 1000.0)


def test_range_share_is_the_union_over_the_stretch():
    run = _run([
        STRETCH,
        _event("runtime.gc.full", 100.0, 300.0),
        _event("runtime.gc.young", 200.0, 250.0),     # nested
        _event("runtime.gc.young", 280.0, 400.0),     # overlapping
        _event("runtime.gc.full", 950.0, 1100.0),     # past the stretch
        _event("runtime.gc.full", -50.0, 20.0),       # before it
        _event("scoring.dispatch", 500.0, 600.0),     # another prefix
        # a device-side copy of a host label is no host range either
        _event("runtime.gc.full", 600.0, 700.0, DeviceType.CUDA, True),
    ])
    assert range_share.read(run, prefix="runtime.gc") == pytest.approx(
        100.0 * (300 + 50 + 20) / 1000)
    assert range_share.read(run, prefix="scoring.dispatch") == \
        pytest.approx(10.0)


def test_idle_under_range_subtracts_device_work():
    run = _run([
        STRETCH,
        _event("scoring.dispatch", 100.0, 300.0),
        _event("scoring.dispatch", 150.0, 200.0),     # nested
        _event("scoring.dispatch", 250.0, 400.0),     # overlapping
        _event("kernel_a", 120.0, 180.0, DeviceType.CUDA),
        _event("kernel_b", 170.0, 210.0, DeviceType.CUDA),   # overlaps a
        _event("kernel_c", 390.0, 450.0, DeviceType.CUDA),   # past the range
        # the device-side copy of the label: excluded, not device work
        _event("scoring.dispatch", 100.0, 400.0, DeviceType.CUDA, True),
    ])
    # open 100–400 (300 µs), device busy in it 120–210 and 390–400
    assert idle_under_range.read(run, prefix="scoring.dispatch") == \
        pytest.approx(100.0 * (300 - 90 - 10) / 1000)


def test_readers_read_zero_where_no_range_falls():
    run = _run([STRETCH, _event("kernel_a", 0.0, 10.0, DeviceType.CUDA),
                _event("runtime.gc.full", 1200.0, 1300.0)])
    assert range_share.read(run, prefix="runtime.gc") == 0.0
    assert idle_under_range.read(run, prefix="runtime.gc") == 0.0


def test_readers_read_nothing_without_a_trace():
    assert range_share.read(SimpleNamespace(stretch=None),
                            prefix="runtime.gc") is None
    assert idle_under_range.read(_run([STRETCH], on_card=False),
                                 prefix="runtime.gc") is None
    # the stretch's own label missing
    assert range_share.read(_run([_event("runtime.gc.full", 0.0, 5.0)]),
                            prefix="runtime.gc") is None


def test_idle_by_host_counts_each_instant_once():
    run = _run([
        STRETCH,
        _event("scoring.dispatch", 100.0, 400.0),
        _event("runtime.gc.full", 200.0, 300.0),      # inside the dispatch
        _event("event-management.persist", 350.0, 500.0),
        _event("scoring.settle", 600.0, 650.0),
        _event("event-sources.decode", 640.0, 700.0),
        _event("kernel_a", 380.0, 420.0, DeviceType.CUDA),
        _event("scoring.dispatch", 100.0, 400.0, DeviceType.CUDA, True),
    ])
    got = idle_by_host.breakdown(range_share.walk(run))
    assert got["stretch_us"] == 1000.0
    assert got["share_pct"] == pytest.approx({
        "gc": 10.0,                 # 200–300
        "dispatch": 18.0,           # 100–200, 300–380
        "persist": 8.0,             # 420–500
        "settle": 5.0,              # 600–650
        "other_spans": 5.0,         # 650–700
        "nothing": 50.0,            # 0–100, 500–600, 700–1000
        "device_busy": 4.0,         # 380–420
    })
    assert sum(got["share_pct"].values()) == pytest.approx(100.0)
    assert got["ranges"] == {"scoring.dispatch": 1, "runtime.gc.full": 1,
                             "event-management.persist": 1,
                             "scoring.settle": 1, "event-sources.decode": 1}
