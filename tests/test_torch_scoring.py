"""The port's scoring session (sitewhere_tpu_torch/scoring/) as a whole,
held against the JAX package's session, plus tests/test_scoring.py's
admission, backpressure and dispatch-count cases run on the port.

Both sessions score on the CPU with `score_dtype="float32"`, on the
same weights and the same simulator ticks. The port takes the kernel
semantics (f32 accumulation) and JAX on the CPU takes its scan path
(tests/test_pallas.py allows the same gap): per-event scores agree
within 3e-2 in normalized units.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch

from sitewhere_tpu.domain.batch import BatchContext as JBatchContext
from sitewhere_tpu.domain.batch import MeasurementBatch as JBatch
from sitewhere_tpu.kernel.metrics import MetricsRegistry as JMetrics
from sitewhere_tpu.models import build_model as jax_build
from sitewhere_tpu.persistence.telemetry import TelemetryStore as JStore
from sitewhere_tpu.scoring.server import ScoringConfig as JConfig
from sitewhere_tpu.scoring.server import ScoringSession as JSession
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.ops import lstm_kernel
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)


def _fill_store(store, sim, ticks: int, t0: float = 0.0):
    for k in range(ticks):
        batch, _ = sim.tick(t=t0 + 60.0 * k)
        store.append_measurements(batch)


def _session(model: str, store, metrics=None, sink=None, **cfg):
    return ScoringSession(build_model(model, device="cpu", **_model_cfg(cfg)),
                          store, metrics or MetricsRegistry(),
                          ScoringConfig(**cfg), sink=sink, device="cpu")


def _model_cfg(cfg: dict) -> dict:
    return {"window": cfg.pop("window")}


def _jbatch(b: MeasurementBatch) -> JBatch:
    return JBatch(JBatchContext(tenant_id=b.ctx.tenant_id, source=b.ctx.source),
                  b.device_index, b.mtype, b.value, b.ts)


# -- the slice as a whole: port session vs JAX session -----------------------


def test_session_matches_jax_session(run):
    """Same ticks through both sessions: a plain flush larger than the max
    bucket (chunked), a flush holding duplicate devices (occurrence
    rounds), and an anomaly tick."""

    async def main():
        window, n_dev = 32, 150
        cfg = dict(buckets=(64, 128), batch_window_ms=0.0, threshold=4.0,
                   score_dtype="float32")
        jmodel = jax_build("lstm", window=window, hidden=32)
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        jstore, tstore = JStore(history=64), TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=n_dev, seed=5), tenant_id="t")
        for k in range(window + 4):
            batch, _ = sim.tick(t=60.0 * k)
            jstore.append_measurements(_jbatch(batch))
            tstore.append_measurements(batch)
        js = JSession(jmodel, jstore, JMetrics(), JConfig(**cfg), params=params)
        ts = ScoringSession(
            build_model("lstm", device="cpu", window=window, hidden=32),
            tstore, MetricsRegistry(), ScoringConfig(**cfg),
            params=params_from_numpy(params, "cpu"), device="cpu")
        js.warmup()
        ts.warmup()

        def flushes():
            t = 60.0 * (window + 4)
            batch, _ = sim.tick(t=t)          # 150 devices > bucket 128
            yield [batch], None
            dup = np.arange(0, 40, dtype=np.uint32)
            yield [sim.tick(t=t + 60.0, devices=dup)[0],
                   sim.tick(t=t + 90.0, devices=dup)[0]], None
            sim.cfg = SimConfig(num_devices=n_dev, seed=5, anomaly_rate=0.1,
                                anomaly_magnitude=12.0)
            batch, truth = sim.tick(t=t + 120.0)
            yield [batch], truth

        anomaly_scores = None
        for batches, truth in flushes():
            for b in batches:
                jstore.append_measurements(_jbatch(b))
                tstore.append_measurements(b)
                js.admit(_jbatch(b))
                ts.admit(b)
            want, got = await js.flush(), await ts.flush()
            np.testing.assert_array_equal(got.device_index, want.device_index)
            np.testing.assert_allclose(got.score, want.score, atol=3e-2)
            away = np.abs(want.score - cfg["threshold"]) > 0.1
            np.testing.assert_array_equal(got.is_anomaly[away],
                                          want.is_anomaly[away])
            if truth is not None:
                anomaly_scores = (got.score[truth], got.score[~truth])
        anom, normal = anomaly_scores
        assert np.median(anom) > np.quantile(normal, 0.99)
        assert ts.dispatches.value == js.dispatches.value == 6  # 2 + 2 + 2
        # the ring windows agree with the JAX ring after all of it
        devices = np.arange(n_dev)
        jx, jv = js.ring.windows(devices)
        tx, tv = ts.ring.windows(devices)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tx.numpy()[tv.numpy()],
                                      np.asarray(jx)[np.asarray(jv)])

    run(main())


def test_width8_session_matches_jax_session(run):
    """An `lstm` session at hidden=8 (the width the service tests
    configure) takes the kernel path (on the CPU its plain version) and
    scores like the JAX session on the same weights and ticks, float32
    readback, atol 3e-2 as above."""

    async def main():
        window, n_dev = 16, 40
        cfg = dict(buckets=(32, 64), batch_window_ms=0.0,
                   score_dtype="float32")
        jmodel = jax_build("lstm", window=window, hidden=8)
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
        jstore, tstore = JStore(history=64), TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=n_dev, seed=9), tenant_id="t")
        for k in range(window + 4):
            batch, _ = sim.tick(t=60.0 * k)
            jstore.append_measurements(_jbatch(batch))
            tstore.append_measurements(batch)
        js = JSession(jmodel, jstore, JMetrics(), JConfig(**cfg), params=params)
        ts = ScoringSession(
            build_model("lstm", device="cpu", window=window, hidden=8),
            tstore, MetricsRegistry(), ScoringConfig(**cfg),
            params=params_from_numpy(params, "cpu"), device="cpu")
        assert ts.model.fused
        js.warmup()
        ts.warmup()
        t = 60.0 * (window + 4)
        for k, devices in enumerate((None, np.arange(10, dtype=np.uint32))):
            batch, _ = sim.tick(t=t + 60.0 * k, devices=devices)
            jstore.append_measurements(_jbatch(batch))
            tstore.append_measurements(batch)
            js.admit(_jbatch(batch))
            ts.admit(batch)
            want, got = await js.flush(), await ts.flush()
            assert len(got) == len(batch)
            np.testing.assert_array_equal(got.device_index, want.device_index)
            np.testing.assert_allclose(got.score, want.score, atol=3e-2)

    run(main())


def test_query_path_matches_jax(run):
    """score_devices (host windows, the model's scan `score`) on both
    packages: atol 3e-2."""

    async def main():
        jmodel = jax_build("lstm", window=32, hidden=32)
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(1)))
        jstore, tstore = JStore(history=64), TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=100, seed=8), tenant_id="t")
        for k in range(40):
            batch, _ = sim.tick(t=60.0 * k)
            jstore.append_measurements(_jbatch(batch))
            tstore.append_measurements(batch)
        cfg = dict(buckets=(64,), score_dtype="float32")
        js = JSession(jmodel, jstore, JMetrics(), JConfig(**cfg), params=params)
        ts = ScoringSession(
            build_model("lstm", device="cpu", window=32, hidden=32), tstore,
            MetricsRegistry(), ScoringConfig(**cfg),
            params=params_from_numpy(params, "cpu"), device="cpu")
        dev = np.arange(100, dtype=np.uint32)
        z = np.zeros(100)
        want = await js.score_devices(dev, z, z, JBatchContext(tenant_id="t"))
        got = await ts.score_devices(dev, z, z, BatchContext(tenant_id="t"))
        np.testing.assert_allclose(got.score, want.score, atol=3e-2)

    run(main())


def test_lstm_session_takes_the_kernel_path(run):
    """A single-layer bf16 LSTM session scores through score_fused; on the
    CPU that is the kernel's plain version, which counts no launch."""

    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=20, seed=2), tenant_id="t")
        _fill_store(store, sim, 20)
        session = _session("lstm", store, window=16, buckets=(32,),
                           batch_window_ms=0.0)
        assert session.model.fused
        calls = []
        real = session.model.score_fused
        session.model.score_fused = lambda *a: calls.append(1) or real(*a)
        before = lstm_kernel.launches
        session.warmup()
        session.admit(sim.tick(t=60.0 * 21)[0])
        scored = await session.flush()
        assert len(scored) == 20 and np.isfinite(scored.score).all()
        assert len(calls) == 2  # warmup bucket + one flush
        assert lstm_kernel.launches == before
        assert session.ring.kernel_launches == before

    run(main())


def test_swb1_round_trip_feeds_the_session(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=30, seed=4), tenant_id="t")
        _fill_store(store, sim, 20)
        session = _session("zscore", store, window=16, buckets=(32,),
                           batch_window_ms=0.0)
        session.warmup()
        payload, _ = sim.payload(t=60.0 * 21)
        batch = MeasurementBatch.decode(payload, BatchContext(tenant_id="t"))
        assert batch.encode() == payload
        store.append_measurements(batch)
        session.admit(batch)
        scored = await session.flush()
        np.testing.assert_array_equal(scored.device_index, np.arange(30))

    run(main())


# -- tests/test_scoring.py's cases, on the port -------------------------------


def test_scoring_session_detects_injected_anomalies(run):
    async def main():
        store = TelemetryStore(history=128)
        sim = DeviceSimulator(SimConfig(num_devices=200, seed=3), tenant_id="t")
        _fill_store(store, sim, 70)
        session = _session("zscore", store, window=64, buckets=(256,),
                           threshold=4.0)
        session.warmup()
        sim.cfg = SimConfig(num_devices=200, seed=3, anomaly_rate=0.05,
                            anomaly_magnitude=12.0)
        batch, truth = sim.tick(t=70 * 60.0)
        store.append_measurements(batch)
        scored = await session.score_devices(
            batch.device_index, batch.ts, np.zeros(len(batch)), batch.ctx)
        detected = scored.is_anomaly
        assert (detected == truth).mean() > 0.97
        assert detected[truth].mean() > 0.9

    run(main())


def test_scoring_bucket_padding_and_chunking(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=600), tenant_id="t")
        _fill_store(store, sim, 40)
        session = _session("zscore", store, window=32, buckets=(64, 256))
        devices = np.arange(600, dtype=np.uint32)
        scored = await session.score_devices(
            devices, np.zeros(600), np.zeros(600), BatchContext(tenant_id="t"))
        assert len(scored) == 600
        assert np.isfinite(scored.score).all()

    run(main())


def test_admission_batching_deadline(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=10), tenant_id="t")
        _fill_store(store, sim, 40)
        session = _session("zscore", store, window=32, buckets=(64,),
                           batch_window_ms=5.0)
        batch, _ = sim.tick(t=41 * 60.0)
        assert not session.flush_due
        session.admit(batch)
        assert not session.flush_due  # deadline not reached
        await asyncio.sleep(0.006)
        assert session.flush_due
        scored = await session.flush()
        assert len(scored) == 10
        assert session.flush_due is False and await session.flush() is None

    run(main())


def test_flush_chunks_fleets_larger_than_max_bucket(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=300), tenant_id="t")
        _fill_store(store, sim, 40)
        delivered = []

        async def sink(batch):
            delivered.append(batch)

        session = _session("zscore", store, sink=sink, window=32,
                           buckets=(128,), batch_window_ms=0.0)
        session.warmup()
        batch, _ = sim.tick(t=41 * 60.0)  # 300 devices > bucket 128
        session.admit(batch)
        scored = await session.flush()
        assert len(scored) == 300
        assert np.isfinite(scored.score).all()
        await session.drain()
        assert session.inflight == 0
        assert sum(len(b) for b in delivered) == 300

    run(main())


def test_ring_duplicate_devices_in_one_flush(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=8), tenant_id="t")
        _fill_store(store, sim, 40)
        session = _session("zscore", store, window=16, buckets=(32,),
                           batch_window_ms=0.0, threshold=4.0)
        session.warmup()
        ctx = BatchContext(tenant_id="t", source="test")
        c3 = float(store.window(np.array([3]), 1)[0][0, 0])
        c5 = float(store.window(np.array([5]), 1)[0][0, 0])
        batch = MeasurementBatch(
            ctx, device_index=np.array([3, 5, 3, 3], np.uint32),
            mtype=np.zeros(4, np.uint16),
            value=np.array([c3, c5, c3, 500.0], np.float32),
            ts=np.full(4, 41 * 60.0))
        session.admit(batch)
        scored = await session.flush()
        assert len(scored) == 4
        d3 = scored.score[scored.device_index == 3]
        assert d3[0] < 4.0 and d3[1] < 4.0 and d3[2] > 4.0
        assert scored.score[scored.device_index == 5][0] < 4.0
        x, _ = session.ring.windows(np.array([3]))
        got = x.numpy()[0, -3:]
        np.testing.assert_allclose(got, [c3, c3, 500.0], rtol=1e-6)

    run(main())


def test_ring_matches_host_store_windows(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=50), tenant_id="t")
        _fill_store(store, sim, 20)
        session = _session("zscore", store, window=16, buckets=(64,),
                           batch_window_ms=0.0)
        session.warmup()
        for k in range(21, 25):
            batch, _ = sim.tick(t=60.0 * k)
            store.append_measurements(batch)
            session.admit(batch)
            await session.flush()
        devices = np.arange(50, dtype=np.uint32)
        want_x, want_v = store.window(devices, 16)
        got_x, got_v = (t.numpy() for t in session.ring.windows(devices))
        np.testing.assert_allclose(got_x[want_v], want_x[want_v], rtol=1e-6)
        assert (got_v == want_v).all()

    run(main())


def test_admission_backpressure_never_drops(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=100, seed=1), tenant_id="t")
        _fill_store(store, sim, 40)
        session = _session("zscore", store, window=32, buckets=(128,),
                           threshold=4.0)
        session.ready = False  # simulate a long warmup/regrow
        total = 0
        for k in range(30):  # 3000 > default cap 4*128 = 512
            batch, _ = sim.tick(t=(40 + k) * 60.0)
            session.admit(batch)
            total += len(batch)
        assert session.pending_n == total  # nothing dropped
        assert session.backlogged
        session.warmup()
        scored: list = []

        async def sink(b):
            scored.append(len(b))

        session.sink = sink
        while session.pending_n:
            session.flush_nowait()
            await asyncio.sleep(0.01)
        await session.drain()
        assert sum(scored) == total
        assert not session.backlogged

    run(main())


def test_session_counts_flush_dispatches(run):
    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=300), tenant_id="t")
        _fill_store(store, sim, 40)
        metrics = MetricsRegistry()
        session = _session("zscore", store, metrics, window=32,
                           buckets=(128,), batch_window_ms=0.0)
        session.warmup()
        counter = metrics.counter("scoring.dispatches")
        assert counter.value == 0  # warmup dispatches are not flushes
        batch, _ = sim.tick(t=41 * 60.0)
        session.admit(batch)   # 300 devices > bucket 128 → 3 chunks
        await session.flush()
        assert counter.value == 3

    run(main())


def test_backlog_cap_is_configurable(run):
    async def main():
        assert ScoringConfig(buckets=(128,)).backlog_events == 512
        assert ScoringConfig(buckets=(128,),
                             backlog_cap=100).backlog_events == 100
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=50, seed=1), tenant_id="t")
        _fill_store(store, sim, 40)
        session = _session("zscore", store, window=32, buckets=(128,),
                           backlog_cap=100)
        session.ready = False
        session.admit(sim.tick(t=40 * 60.0)[0])  # 50 events < 100
        assert not session.backlogged
        session.admit(sim.tick(t=41 * 60.0)[0])  # 100 events >= 100
        assert session.backlogged

    run(main())


def test_regrow_when_a_device_outgrows_the_ring(run):
    """An admit past the ring's capacity grows it off the hot path and
    the held flush then scores every event."""

    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=10), tenant_id="t")
        _fill_store(store, sim, 20)
        delivered = []

        async def sink(b):
            delivered.append(b)

        session = _session("zscore", store, sink=sink, window=16,
                           buckets=(32,), batch_window_ms=0.0)
        session.warmup()
        cap = session.ring.capacity
        far = np.array([3, cap + 5], np.uint32)
        session.admit(MeasurementBatch(
            BatchContext(tenant_id="t"), far, np.zeros(2, np.uint16),
            np.ones(2, np.float32), np.zeros(2)))
        assert session.flush_nowait() is False  # regrow started
        for _ in range(200):
            if session.ready:
                break
            await asyncio.sleep(0.01)
        assert session.ring.capacity > cap + 5
        assert session.flush_nowait()
        await session.drain()
        assert sum(len(b) for b in delivered) == 2

    run(main())


@pytest.mark.parametrize("score_dtype,want", [("float16", "float16"),
                                              ("float32", "float32")])
def test_ring_narrows_scores(score_dtype, want):
    from sitewhere_tpu_torch.scoring.ring import DeviceRing

    ring = DeviceRing(window=8, capacity=16, score_dtype=score_dtype,
                      device="cpu")
    model = build_model("zscore", device="cpu", window=8)
    out = ring.update_and_score(model, {}, np.array([1, 2], np.int32),
                                np.ones(2, np.float32), 4)
    assert str(out.dtype) == f"torch.{want}" and out.shape == (4,)
    assert ring.count[1].item() == 1 and ring.cursor[2].item() == 1


def test_telemetry_store_matches_jax_store():
    """The port's numpy-only store against the JAX package's store on the
    same appends, in-batch duplicates and a capacity growth included:
    exact."""
    rng = np.random.default_rng(12)
    jstore, tstore = JStore(history=16, initial_devices=8), \
        TelemetryStore(history=16, initial_devices=8)
    for k in range(30):
        dev = rng.integers(0, 20, size=25).astype(np.uint32)
        val = rng.standard_normal(25).astype(np.float32)
        ts = np.full(25, float(k))
        batch = MeasurementBatch(BatchContext(tenant_id="t"), dev,
                                 np.zeros(25, np.uint16), val, ts)
        jstore.append_measurements(_jbatch(batch))
        tstore.append_measurements(batch)
    devices = np.arange(20)
    for got, want in zip(tstore.window(devices, 12), jstore.window(devices, 12)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tstore.channel(0).latest(devices),
                         jstore.channel(0).latest(devices)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tstore.snapshot(), jstore.snapshot()):
        np.testing.assert_array_equal(got, want)
    assert tstore.total_events == jstore.total_events == 750


def test_simulator_and_swb1_match_jax():
    """Same seed, same ticks (values, anomalies, subsets) and the same
    SWB1 bytes as the JAX package's simulator: exact."""
    from sitewhere_tpu.sim.simulator import DeviceSimulator as JSim
    from sitewhere_tpu.sim.simulator import SimConfig as JSimConfig

    kw = dict(num_devices=64, seed=9, anomaly_rate=0.2, anomaly_magnitude=10.0,
              drift_fraction=0.3, drift_per_hour=1.0)
    jsim, tsim = JSim(JSimConfig(**kw)), DeviceSimulator(SimConfig(**kw))
    sub = np.arange(10, 30, dtype=np.uint32)
    for k, devices in enumerate((None, sub, None)):
        jb, jt = jsim.tick(t=60.0 * k, devices=devices)
        tb, tt = tsim.tick(t=60.0 * k, devices=devices)
        np.testing.assert_array_equal(tt, jt)
        assert tb.encode() == jb.encode()
