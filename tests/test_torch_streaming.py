"""The port's streaming LSTM path (`StreamingLstmModel`, `StreamingRing`
and the streaming `ScoringSession`) held against the JAX package, plus
tests/test_streaming.py's and tests/test_sparse_readback.py's session
cases run on the port.

Same numpy inputs and weights on both sides (JAX params through
`jax.tree.map(np.asarray, ...)` and `convert.params_from_numpy`).
Tolerances: with `compute_dtype=float32` the cell and the Welford update
agree to 1e-5; at bf16 the port rounds each matmul output to bf16 where
XLA on the CPU does not (ROADMAP C), so state agrees to 1e-2 and scores
to 3e-2.
"""

import jax
import jax.numpy as jnp
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
from sitewhere_tpu_torch.domain.batch import (
    BatchContext,
    MeasurementBatch,
    ScoredBatch,
)
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.scoring.stream import StreamingRing
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

W, H = 32, 16


def _jbatch(b: MeasurementBatch) -> JBatch:
    return JBatch(JBatchContext(tenant_id=b.ctx.tenant_id, source=b.ctx.source),
                  b.device_index, b.mtype, b.value, b.ts)


def _fill_store(store, sim, ticks: int, t0: float = 0.0):
    for k in range(ticks):
        store.append_measurements(sim.tick(t=t0 + 60.0 * k)[0])


def _session(store, readback="full", sparse_k=0, buckets=(64,),
             params=None, **cfg):
    s = ScoringSession(
        build_model("lstm-stream", device="cpu", window=W, hidden=H), store,
        MetricsRegistry(),
        ScoringConfig(buckets=buckets, threshold=4.0, readback=readback,
                      sparse_k=sparse_k, seed=7, **cfg),
        params=params, device="cpu")
    s.warmup()
    return s


def _windows(rng, n, w):
    x = rng.normal(20.0, 2.0, (n, w)).astype(np.float32)
    count = rng.integers(0, w + 1, n)
    count[:4] = (0, 1, w, w)  # empty, one step, full rows
    valid = np.arange(w)[None, :] >= (w - count)[:, None]
    return x, valid


def _models(compute_dtype, layers=1):
    jm = jax_build("lstm-stream", window=W, hidden=H, layers=layers,
                   compute_dtype={"float32": jnp.float32,
                                  "bfloat16": jnp.bfloat16}[compute_dtype])
    tm = build_model("lstm-stream", device="cpu", window=W, hidden=H,
                     layers=layers, compute_dtype=getattr(torch, compute_dtype))
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(layers)))
    return jm, tm, params, params_from_numpy(params, "cpu")


def _run_steps(jm, tm, jp, tp, seed, steps=6, chained=True):
    """warm_state on the same windows, then `steps` step_score calls on
    the same values (the first a 10-sigma jump). Chained, each package
    steps its own state; otherwise the port steps from the JAX state, so
    each call is compared alone. Returns the warm states, the per-step
    (JAX, port) scores and the (JAX, port) states after every step."""
    rng = np.random.default_rng(seed)
    x, valid = _windows(rng, 48, W)
    js = jm.warm_state(jp, jnp.asarray(x), jnp.asarray(valid))
    ts = tm.warm_state(tp, torch.from_numpy(x), torch.from_numpy(valid))
    states = [(jax.tree.map(np.asarray, js),
               {k: v.numpy() for k, v in ts.items()})]
    scores = []
    for k in range(steps):
        v = rng.normal(20.0, 2.0, 48).astype(np.float32)
        if k == 0:
            v[5:9] += 20.0
        if not chained:
            ts = {k: torch.from_numpy(np.array(a)) for k, a in states[-1][0].items()}
        jsc, js = jm.step_score(jp, js, jnp.asarray(v))
        tsc, ts = tm.step_score(tp, ts, torch.from_numpy(v))
        scores.append((np.asarray(jsc), tsc.numpy()))
        states.append((jax.tree.map(np.asarray, js),
                       {k: v.numpy() for k, v in ts.items()}))
    return scores, states


@pytest.mark.parametrize("layers", [1, 2])
def test_step_and_warm_state_match_jax_float32(layers):
    """compute_dtype=float32: no bf16 noise, so any difference in the
    Welford update, the gating, the clipping or the cell shows. Each
    step_score starts from the JAX state, so each call is held alone."""
    jm, tm, jp, tp = _models("float32", layers)
    scores, states = _run_steps(jm, tm, jp, tp, seed=layers, chained=False)
    for want, got in states:
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_allclose(got[k], want[k], atol=1e-5, err_msg=k)
    for want, got in scores:
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert scores[0][0][5:9].min() > 4.0  # the jump scores as an anomaly
    assert tm.flops_per_event() == jm.flops_per_event()


def test_step_and_warm_state_match_jax_bfloat16():
    """bf16, each package stepping its own state for six events."""
    jm, tm, jp, tp = _models("bfloat16")
    scores, states = _run_steps(jm, tm, jp, tp, seed=3)
    for want, got in states:
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-2, err_msg=k)
    for want, got in scores:
        np.testing.assert_allclose(got, want, atol=3e-2)


def test_streaming_session_matches_jax_session(run):
    """Same ticks through both streaming sessions: a flush larger than
    the max bucket (chunked), a flush holding duplicate devices
    (occurrence rounds) and an anomaly tick. float32 readback, bf16
    model: atol 3e-2."""

    async def main():
        n_dev = 150
        cfg = dict(buckets=(64, 128), batch_window_ms=0.0, threshold=4.0,
                   score_dtype="float32")
        jmodel = jax_build("lstm-stream", window=W, hidden=H)
        params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0)))
        jstore, tstore = JStore(history=64), TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=n_dev, seed=5),
                              tenant_id="t")
        for k in range(W + 4):
            batch, _ = sim.tick(t=60.0 * k)
            jstore.append_measurements(_jbatch(batch))
            tstore.append_measurements(batch)
        js = JSession(jmodel, jstore, JMetrics(), JConfig(**cfg), params=params)
        ts = ScoringSession(
            build_model("lstm-stream", device="cpu", window=W, hidden=H),
            tstore, MetricsRegistry(), ScoringConfig(**cfg),
            params=params_from_numpy(params, "cpu"), device="cpu")
        js.warmup()
        ts.warmup()
        assert isinstance(ts.ring, StreamingRing)

        def flushes():
            t = 60.0 * (W + 4)
            yield [sim.tick(t=t)[0]], None          # 150 devices > 128
            dup = np.arange(0, 40, dtype=np.uint32)
            yield [sim.tick(t=t + 60.0, devices=dup)[0],
                   sim.tick(t=t + 90.0, devices=dup)[0]], None
            sim.cfg = SimConfig(num_devices=n_dev, seed=5, anomaly_rate=0.1,
                                anomaly_magnitude=12.0)
            batch, truth = sim.tick(t=t + 120.0)
            yield [batch], truth

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
                assert np.median(got.score[truth]) > np.quantile(
                    got.score[~truth], 0.99)
        assert ts.dispatches.value == js.dispatches.value == 6  # 2 + 2 + 2
        for k in ("mean", "var", "count", "pred", "h0", "c0"):
            np.testing.assert_allclose(ts.ring.state[k][:n_dev].numpy(),
                                       np.asarray(js.ring.state[k][:n_dev]),
                                       atol=3e-2, err_msg=k)
        ts.close()

    run(main())


# -- tests/test_sparse_readback.py's cases, on the port -----------------------


def _anomaly_map(scored):
    keep = scored.is_anomaly
    return {int(d): float(s) for d, s in zip(scored.device_index[keep],
                                             scored.score[keep])}


def test_sparse_matches_full_readback(run):
    """Same anomaly set and scores (float16 readback on both) per flush,
    flushes smaller than the bucket included (padding masked)."""

    async def main():
        stores, sims = [], []
        for _ in range(2):
            sim = DeviceSimulator(SimConfig(num_devices=100, seed=3),
                                  tenant_id="t")
            store = TelemetryStore(history=64, initial_devices=100)
            _fill_store(store, sim, W + 4)
            stores.append(store)
            sims.append(sim)
        full = _session(stores[0], "full", buckets=(128,))
        sparse = _session(stores[1], "anomalies", buckets=(128,))
        for sim in sims:
            sim.cfg = SimConfig(num_devices=100, seed=3, anomaly_rate=0.05,
                                anomaly_magnitude=12.0)
        for k in range(4):
            t = 60.0 * (W + 4 + k)
            devices = None if k < 3 else np.arange(30, dtype=np.uint32)
            full.admit(sims[0].tick(t=t, devices=devices)[0])
            sparse.admit(sims[1].tick(t=t, devices=devices)[0])
            scored_f, scored_s = await full.flush(), await sparse.flush()
            want = _anomaly_map(scored_f)
            assert want or k == 3  # full ticks all hold anomalies
            got = {int(d): float(s) for d, s in zip(scored_s.device_index,
                                                    scored_s.score)}
            assert got == want
            assert scored_s.is_anomaly.all()
            assert scored_s.total_scored == len(scored_f)
            assert scored_f.total_scored == -1
        assert full.latency.count == sparse.latency.count == 330
        full.close()
        sparse.close()

    run(main())


def test_sparse_duplicate_devices_rounds(run):
    """A flush carrying several events for one device scores each
    occurrence (rounds) and reports every anomalous one."""

    async def main():
        store = TelemetryStore(history=64, initial_devices=64)
        sim = DeviceSimulator(SimConfig(num_devices=64, seed=1), tenant_id="t")
        _fill_store(store, sim, W + 4)
        s = _session(store, "anomalies")
        dev = np.array([5, 9, 5], np.uint32)
        s.admit(MeasurementBatch(BatchContext(tenant_id="t", source="x"), dev,
                                 np.zeros(3, np.uint16),
                                 np.full(3, 1e4, np.float32),
                                 np.full(3, 4300.0)))
        scored = await s.flush()
        assert sorted(scored.device_index.tolist()) == [5, 5, 9]
        assert scored.is_anomaly.all() and (scored.score >= 4.0).all()
        assert s.dispatches.value == 2
        s.close()

    run(main())


def test_sparse_topk_overflow_is_counted(run):
    """More anomalies than k slots: the top k are reported, the overflow
    counter carries the remainder — never a silent truncation."""

    async def main():
        store = TelemetryStore(history=64, initial_devices=100)
        sim = DeviceSimulator(SimConfig(num_devices=100, seed=3),
                              tenant_id="t")
        _fill_store(store, sim, W + 4)
        full = _session(store, "full", buckets=(128,))
        s = _session(store, "anomalies", sparse_k=4, buckets=(128,))
        sim.cfg = SimConfig(num_devices=100, seed=3, anomaly_rate=1.0,
                            anomaly_magnitude=12.0)
        batch, _ = sim.tick(t=60.0 * (W + 4))
        full.admit(batch)
        s.admit(batch)
        scored_f, scored = await full.flush(), await s.flush()
        n_anom = int(scored_f.is_anomaly.sum())
        assert n_anom > 4
        assert len(scored) == 4                      # k slots
        assert len(scored) + s.anomaly_overflow.value == n_anom
        # the k reported are among the anomalies, with their scores
        want = _anomaly_map(scored_f)
        for d, v in zip(scored.device_index, scored.score):
            assert want[int(d)] == pytest.approx(v, abs=1e-6)
        assert scored.total_scored == 100
        full.close()
        s.close()

    run(main())


def test_sparse_multichunk_flush_total_scored(run):
    """A sparse flush larger than the max bucket merges chunks with the
    TRUE scored count (-1 would claim full readback)."""

    async def main():
        store = TelemetryStore(history=64, initial_devices=150)
        sim = DeviceSimulator(SimConfig(num_devices=150, seed=2),
                              tenant_id="t")
        _fill_store(store, sim, W + 4)
        s = _session(store, "anomalies", buckets=(64,))
        sim.cfg = SimConfig(num_devices=150, seed=2, anomaly_rate=0.05,
                            anomaly_magnitude=12.0)
        batch, truth = sim.tick(t=60.0 * (W + 4))
        s.admit(batch)
        scored = await s.flush()
        assert scored.total_scored == 150          # 3 chunks of ≤64
        assert s.dispatches.value == 3
        assert set(np.nonzero(truth)[0]) <= set(scored.device_index.tolist())
        s.close()

    run(main())


# -- tests/test_streaming.py's session cases, on the port ---------------------


def test_streaming_swap_params_reseeds_state(run):
    """A checkpoint rollout reseeds the resident state under the NEW
    weights, exactly as a session born with them seeds it."""

    async def main():
        store = TelemetryStore(history=64, initial_devices=50)
        sim = DeviceSimulator(SimConfig(num_devices=50, seed=5), tenant_id="t")
        _fill_store(store, sim, W + 4)
        s = _session(store)
        old_pred = s.ring.state["pred"][:50].clone()
        new_params = s.model.init(torch.Generator().manual_seed(99))
        assert s.swap_params(new_params) == 1
        fresh = _session(store, params=new_params)
        np.testing.assert_allclose(s.ring.state["pred"][:50].numpy(),
                                   fresh.ring.state["pred"][:50].numpy(),
                                   atol=1e-6)
        assert (s.ring.state["pred"][:50] - old_pred).abs().max() > 1e-3
        s.close()
        fresh.close()

    run(main())


def test_streaming_regrow_preserves_state(run):
    """A device index past capacity triggers a regrow off the hot path;
    old devices keep their state, new rows start cold, and the held
    flush then scores every event."""

    async def main():
        store = TelemetryStore(history=64, initial_devices=100)
        sim = DeviceSimulator(SimConfig(num_devices=100, seed=1), tenant_id="t")
        _fill_store(store, sim, W + 4)
        s = _session(store, buckets=(128,))
        cap0 = s.ring.capacity
        before = {k: v[:100].clone() for k, v in s.ring.state.items()}
        delivered = []

        async def sink(b):
            delivered.append(b)

        s.sink = sink
        batch, _ = sim.tick(t=60.0 * (W + 4))
        far = MeasurementBatch(BatchContext(tenant_id="t"),
                               np.array([3, cap0 + 5], np.uint32),
                               np.zeros(2, np.uint16),
                               np.array([20.0, 20.0], np.float32),
                               np.zeros(2))
        s.admit(far)
        assert s.flush_nowait() is False  # regrow started
        await wait_until(lambda: s.ready, timeout=10.0)
        assert s.ring.capacity > cap0 + 5
        for k, v in before.items():
            if k != "count":
                torch.testing.assert_close(s.ring.state[k][:100], v)
        assert s.ring.state["count"][:100].min() >= 8
        assert s.ring.state["count"][cap0:cap0 + 5].max() == 0
        s.admit(batch)
        assert s.flush_nowait()
        await s.drain()
        assert sum(len(b) for b in delivered) == 102
        s.close()

    run(main())


def test_streaming_fault_recovery_reloads_from_host(run):
    """A dispatch that fails mid-update marks the ring faulted; the
    session rebuilds it and reseeds it from the host store, to the same
    state a fresh session seeds."""

    async def main():
        store = TelemetryStore(history=64, initial_devices=50)
        sim = DeviceSimulator(SimConfig(num_devices=50, seed=2), tenant_id="t")
        _fill_store(store, sim, W + 4)
        s = _session(store)
        ring = s.ring

        def boom(*a):
            raise RuntimeError("injected device fault")

        ring._step = boom
        s.admit(sim.tick(t=60.0 * (W + 4))[0])
        with pytest.raises(RuntimeError, match="dispatch failed"):
            await s.flush()
        assert ring.faulted and s.ring is not ring
        assert s.dropped.value == 50
        fresh = _session(store)
        for k, v in fresh.ring.state.items():
            torch.testing.assert_close(s.ring.state[k][:50], v[:50])
        s.admit(sim.tick(t=60.0 * (W + 5))[0])
        assert len(await s.flush()) == 50
        s.close()
        fresh.close()

    run(main())


def test_streaming_ring_refuses_out_of_range_ids():
    """Every id is checked on the host before a launch (on the card an
    out-of-range index would end the CUDA context)."""
    model = build_model("lstm-stream", device="cpu", window=8, hidden=8)
    ring = StreamingRing(model, capacity=16, device="cpu")
    params = model.init()
    before = {k: v.clone() for k, v in ring.state.items()}
    for bad in ([3, ring.capacity], [-1]):
        with pytest.raises(IndexError):
            ring.update_and_score(model, params, np.array(bad),
                                  np.ones(len(bad), np.float32), 4)
    for k, v in before.items():
        torch.testing.assert_close(ring.state[k], v)
    assert not ring.faulted


def test_scored_batch_select_and_gauge():
    ctx = BatchContext(tenant_id="t")
    b = ScoredBatch(ctx, np.arange(4, dtype=np.uint32),
                    np.arange(4, dtype=np.float32), np.array([1, 0, 1, 0], bool),
                    np.zeros(4), model_version=3, total_scored=9)
    sel = b.select(b.is_anomaly)
    assert sel.device_index.tolist() == [0, 2]
    assert (sel.model_version, sel.total_scored) == (3, 9)
    metrics = MetricsRegistry()
    metrics.gauge("g").set(2.5)
    assert metrics.gauge("g").value == 2.5
    assert metrics.snapshot()["g"] == 2.5
