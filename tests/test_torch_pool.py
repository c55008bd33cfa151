"""The port's shared scoring pool (`SharedScoringPool`, `TenantStack`,
`StackedStreamingRing`, `StackedDeviceRing`) held against the JAX
package's pool and against the port's own dedicated sessions, plus the
pool behaviour cases of tests/test_megabatch.py, tests/test_multitenant.py
and tests/test_streaming.py run on the port.

Tolerances: pool vs JAX pool 3e-2 (the bf16 rounding gap of ROADMAP C,
float32 readback); the port's pool vs its own dedicated sessions 2e-2
(both read float16 scores back, one float16 ulp at z≈8 is ~0.008);
ring-level stacked vs dedicated 1e-5 (same numerics, the tenant axis
batched by vmap).
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
from sitewhere_tpu.parallel.tenant_stack import TenantStack as JStack
from sitewhere_tpu.persistence.telemetry import TelemetryStore as JStore
from sitewhere_tpu.scoring.pool import PoolConfig as JPoolConfig
from sitewhere_tpu.scoring.pool import SharedScoringPool as JPool
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.parallel import TenantStack
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from sitewhere_tpu_torch.scoring.ring import DeviceRing, StackedDeviceRing
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.scoring.stream import (
    StackedStreamingRing,
    StreamingRing,
)
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

W, H = 32, 16


def _jbatch(b: MeasurementBatch) -> JBatch:
    return JBatch(JBatchContext(tenant_id=b.ctx.tenant_id, source=b.ctx.source),
                  b.device_index, b.mtype, b.value, b.ts)


def _model(name: str, **cfg):
    if name == "zscore":
        return build_model("zscore", device="cpu", window=cfg.get("window", 16))
    return build_model(name, device="cpu", window=cfg.get("window", W),
                       hidden=cfg.get("hidden", H))


def _pool(model, **cfg):
    cfg.setdefault("batch_buckets", (64,))
    cfg.setdefault("batch_window_ms", 1.0)
    return SharedScoringPool(model, MetricsRegistry(), PoolConfig(**cfg),
                             device="cpu")


def _tenant(pool, tid, n_devices, seed, delivered, params=None,
            threshold=4.0, ticks=W + 4):
    store = TelemetryStore(history=64, initial_devices=n_devices)
    sim = DeviceSimulator(SimConfig(num_devices=n_devices, seed=seed),
                          tenant_id=tid)
    for k in range(ticks):
        store.append_measurements(sim.tick(t=60.0 * k)[0])
    delivered[tid] = []

    async def deliver(scored, tid=tid):
        delivered[tid].append(scored)

    slot = pool.register(tid, store, threshold, deliver, params=params)
    return store, sim, slot


def _batch(tid: str, n: int = 8, t: float = 10.0,
           value: float = 21.0) -> MeasurementBatch:
    return MeasurementBatch(
        BatchContext(tenant_id=tid, source="test"),
        np.arange(n, dtype=np.uint32), np.zeros(n, np.uint16),
        np.full(n, value, np.float32), np.full(n, t))


def _by_device(scored):
    order = np.argsort(scored.device_index, kind="stable")
    return scored.device_index[order], scored.score[order]


# -- the path as a whole: port pool vs JAX pool ------------------------------


@pytest.mark.parametrize("name", ["lstm-stream", "lstm"])
def test_pool_matches_jax_pool(run, name):
    """Three tenants with their own weights through both pools, float32
    readback: a plain tick, a flush holding duplicate devices (occurrence
    rounds) and an anomaly tick. Per-tenant scores agree within 3e-2 and
    both pools make the same stacked dispatches."""

    async def main():
        tids = ("a", "b", "c")
        cfg = dict(batch_buckets=(32, 64), batch_window_ms=1.0,
                   score_dtype="float32")
        jmodel = jax_build(name, window=W, hidden=H)
        jpool = JPool(jmodel, JMetrics(), JPoolConfig(**cfg))
        tpool = _pool(_model(name), **cfg)
        got, want, sims, stores = {}, {}, {}, {}
        for i, tid in enumerate(tids):
            params = jax.tree.map(np.asarray,
                                  jmodel.init(jax.random.PRNGKey(10 + i)))
            stores[tid], sims[tid], _ = _tenant(
                tpool, tid, 40, 20 + i, got,
                params=params_from_numpy(params, "cpu"))
            jstore = JStore(history=64, initial_devices=40)
            jsim = DeviceSimulator(SimConfig(num_devices=40, seed=20 + i),
                                   tenant_id=tid)
            for k in range(W + 4):
                jstore.append_measurements(_jbatch(jsim.tick(t=60.0 * k)[0]))
            want[tid] = []

            async def deliver(scored, tid=tid):
                want[tid].append(scored)

            jpool.register(tid, jstore, 4.0, deliver, params=params)
        await wait_until(lambda: jpool.ready and tpool.ready, timeout=60.0)

        def ticks(k):
            t = 60.0 * (W + 4 + k)
            if k == 1:
                dup = np.arange(10, 30, dtype=np.uint32)
                return [(tid, [sims[tid].tick(t=t, devices=dup)[0],
                               sims[tid].tick(t=t + 30.0, devices=dup)[0]])
                        for tid in tids]
            if k == 2:
                for i, tid in enumerate(tids):
                    sims[tid].cfg = SimConfig(num_devices=40, seed=20 + i,
                                              anomaly_rate=0.1,
                                              anomaly_magnitude=12.0)
            return [(tid, [sims[tid].tick(t=t)[0]]) for tid in tids]

        for k in range(3):
            for tid, batches in ticks(k):
                for b in batches:
                    tpool.admit(tid, b)
                    jpool.admit(tid, _jbatch(b))
            await wait_until(lambda k=k: all(
                len(got[t]) == len(want[t]) == k + 1 for t in tids),
                timeout=30.0)
            for tid in tids:
                g, w = got[tid][k], want[tid][k]
                np.testing.assert_array_equal(g.device_index, w.device_index)
                np.testing.assert_allclose(g.score, w.score, atol=3e-2)
        assert tpool.dispatches.value == jpool.dispatches.value == 4
        assert tpool.megabatch_tenants._max == 3.0
        jpool.close()
        tpool.close()

    run(main())


def test_pool_streaming_matches_dedicated_sessions(run):
    """The port's pool against the port's own dedicated streaming
    sessions on the same weights and events (float16 readback on both):
    2e-2."""

    async def main():
        model = _model("lstm-stream")
        params = {tid: model.init(torch.Generator().manual_seed(i + 10))
                  for i, tid in enumerate(("a", "b"))}
        pool = _pool(model)
        delivered: dict = {}
        stores, sims, refs = {}, {}, {}
        for i, tid in enumerate(("a", "b")):
            stores[tid], sims[tid], _ = _tenant(pool, tid, 30, i + 20,
                                                delivered, params=params[tid])
        await wait_until(lambda: pool.ready, timeout=30.0)
        for tid in ("a", "b"):
            refs[tid] = ScoringSession(
                _model("lstm-stream"), stores[tid], MetricsRegistry(),
                ScoringConfig(buckets=(64,)), params=params[tid],
                device="cpu")
            refs[tid].warmup()
        for k in range(3):
            expect = {}
            for tid in ("a", "b"):
                batch, _ = sims[tid].tick(t=60.0 * (W + 4 + k))
                stores[tid].append_measurements(batch)
                pool.admit(tid, batch)
                refs[tid].admit(batch)
                expect[tid] = await refs[tid].flush()
            await wait_until(lambda k=k: all(
                len(delivered[t]) == k + 1 for t in ("a", "b")), timeout=30.0)
            for tid in ("a", "b"):
                gd, gs = _by_device(delivered[tid][k])
                wd, ws = _by_device(expect[tid])
                np.testing.assert_array_equal(gd, wd)
                np.testing.assert_allclose(gs, ws, atol=2e-2)
        for r in refs.values():
            r.close()
        pool.close()

    run(main())


def test_pool_sparse_matches_pool_full(run):
    """Per-tenant thresholds ride as a device vector: the sparse pool
    reports exactly the anomaly set the full pool does, each tenant at
    its own alert bar, with the true scored count."""

    async def main():
        model = _model("lstm-stream")
        params = {tid: model.init(torch.Generator().manual_seed(i + 10))
                  for i, tid in enumerate(("a", "b"))}
        pools, delivered, stores, sims = {}, {}, {}, {}
        for mode in ("full", "anomalies"):
            pools[mode] = _pool(model, readback=mode)
            delivered[mode], stores[mode], sims[mode] = {}, {}, {}
            for i, tid in enumerate(("a", "b")):
                stores[mode][tid], sims[mode][tid], _ = _tenant(
                    pools[mode], tid, 30, i + 20, delivered[mode],
                    params=params[tid],
                    threshold=4.0 if tid == "a" else 6.0)
            await wait_until(lambda p=pools[mode]: p.ready, timeout=30.0)
        for k in range(3):
            for mode in ("full", "anomalies"):
                for i, tid in enumerate(("a", "b")):
                    sims[mode][tid].cfg = SimConfig(
                        num_devices=30, seed=i + 20, anomaly_rate=0.1,
                        anomaly_magnitude=12.0)
                    pools[mode].admit(tid, sims[mode][tid].tick(
                        t=60.0 * (W + 4 + k))[0])
            await wait_until(lambda k=k: all(
                len(delivered[m][t]) == k + 1 for m in delivered
                for t in ("a", "b")), timeout=30.0)
            for tid in ("a", "b"):
                f = delivered["full"][tid][k]
                s = delivered["anomalies"][tid][k]
                want = {int(d): float(v) for d, v in zip(
                    f.device_index[f.is_anomaly], f.score[f.is_anomaly])}
                got = {int(d): float(v) for d, v in zip(s.device_index,
                                                        s.score)}
                assert got == want, (tid, k)
                assert s.is_anomaly.all() and s.total_scored == 30
        assert pools["anomalies"].anomaly_overflow.value == 0
        for pool in pools.values():
            pool.close()

    run(main())


# -- ring level: stacked vs dedicated -----------------------------------------


def test_stacked_streaming_ring_matches_dedicated_rings():
    """One stacked dispatch over three tenants (ragged, scratch-padded
    rows) against each tenant alone in a `StreamingRing`: scores and every
    state leaf to 1e-5; the sparse form reports the same anomalies."""
    model = _model("lstm-stream")
    rng = np.random.default_rng(4)
    stack = TenantStack(model, device="cpu")
    params = [model.init(torch.Generator().manual_seed(30 + t))
              for t in range(3)]
    for t, p in enumerate(params):
        stack.add_tenant(f"t{t}", p)
    stacked = StackedStreamingRing(model, stack.capacity, device_cap=64,
                                   device="cpu")
    sparse = StackedStreamingRing(model, stack.capacity, device_cap=64,
                                  sparse=True, sparse_k=8, device="cpu")
    rings = [StreamingRing(model, capacity=64, device="cpu") for _ in params]
    cap = stacked.device_cap
    x = rng.normal(20.0, 2.0, (cap, W)).astype(np.float32)
    count = rng.integers(0, W + 1, cap)
    for t, (ring, p) in enumerate(zip(rings, params)):
        stacked.load_tenant(t, x, count, p)
        sparse.load_tenant(t, x, count, p)
        ring.bind_params(p)
        ring.load(x, count)
    for step in range(3):
        b = 32
        dev_in = np.full((stack.capacity, b), cap, np.int32)
        val_in = np.zeros((stack.capacity, b), np.float32)
        per = []
        for t in range(3):
            n = (20, 32, 1)[t]
            dev = rng.choice(cap, n, replace=False).astype(np.int32)
            val = rng.normal(20.0, 2.0, n).astype(np.float32)
            val[:2] += 30.0 * (step == 1)
            dev_in[t, :n], val_in[t, :n] = dev, val
            per.append((dev, val))
        out = stacked.update_and_score(model, stack.stacked, dev_in, val_in)
        n_anom, pos, top = sparse.update_and_score(
            model, stack.stacked, dev_in, val_in,
            thresholds=np.array([4.0, 4.0, 4.0, np.inf], np.float32))
        for t, (ring, (dev, val)) in enumerate(zip(rings, per)):
            want = ring.update_and_score(model, params[t], dev, val, b)
            n = dev.shape[0]
            np.testing.assert_allclose(out[t, :n].numpy(), want[:n].numpy(),
                                       atol=1e-5)
            anom = set(np.nonzero(want[:n].numpy() >= 4.0)[0].tolist())
            k = min(int(n_anom[t]), 8)
            assert set(pos[t, :k].tolist()) == anom
            for key, leaf in ring.state.items():
                np.testing.assert_allclose(
                    stacked.state[key][t, :cap].numpy(),
                    leaf[:cap].numpy(), atol=1e-5, err_msg=key)
        assert int(n_anom[3]) == 0  # an empty slot never reports
    assert step == 2


def test_stacked_window_ring_matches_dedicated_rings():
    """The stacked window ring appends like `DeviceRing` and scores each
    tenant's windows with that tenant's params (vmapped `score`): 1e-5."""
    model = _model("lstm")
    rng = np.random.default_rng(5)
    stack = TenantStack(model, device="cpu")
    params = [model.init(torch.Generator().manual_seed(40 + t))
              for t in range(2)]
    for t, p in enumerate(params):
        stack.add_tenant(f"t{t}", p)
    stacked = StackedDeviceRing(W, stack.capacity, device_cap=64,
                                device="cpu")
    rings = [DeviceRing(W, capacity=64, device="cpu") for _ in params]
    cap = stacked.device_cap
    for t, ring in enumerate(rings):
        x = rng.normal(20.0, 2.0, (cap, W)).astype(np.float32)
        count = rng.integers(0, W + 1, cap)
        stacked.load_tenant(t, x, count)
        ring.load(x, count)
    for _ in range(2):
        dev_in = np.full((2, 32), cap, np.int32)
        val_in = np.zeros((2, 32), np.float32)
        per = []
        for t in range(2):
            dev = rng.choice(cap, 24, replace=False).astype(np.int32)
            val = rng.normal(20.0, 2.0, 24).astype(np.float32)
            dev_in[t, :24], val_in[t, :24] = dev, val
            per.append((dev, val))
        out = stacked.update_and_score(model, stack.stacked, dev_in, val_in)
        for t, (ring, (dev, val)) in enumerate(zip(rings, per)):
            # the dedicated ring scores with the window kernel's semantics
            # (score_fused); the pooled path keeps `score`, so hold the
            # stacked scores against `score` on the dedicated ring's windows
            ring.update_and_score(model, params[t], dev, val, 32)
            want = model.score(params[t], *ring.windows(dev))
            np.testing.assert_allclose(out[t, :24].numpy(), want.numpy(),
                                       atol=1e-5)
            gx, gv = stacked.windows(t, np.arange(cap))
            wx, wv = ring.windows(np.arange(cap))
            np.testing.assert_array_equal(gv.numpy(), wv.numpy())
            np.testing.assert_array_equal(gx.numpy()[gv.numpy()],
                                          wx.numpy()[wv.numpy()])


@pytest.mark.parametrize("ring_cls", ["stream", "window"])
def test_stacked_rings_refuse_bad_columns(ring_cls):
    """Ids past a tenant's scratch row, negative ids and a tenant axis
    that does not match the stack are refused on the host, before any
    launch, and leave the state untouched."""
    if ring_cls == "stream":
        model = _model("lstm-stream", window=8, hidden=8)
        ring = StackedStreamingRing(model, 2, device_cap=16, device="cpu")
        snap = lambda: {k: v.clone() for k, v in ring.state.items()}  # noqa: E731
    else:
        model = _model("lstm", window=8, hidden=8)
        ring = StackedDeviceRing(8, 2, device_cap=16, device="cpu")
        snap = lambda: {"values": ring.values.clone()}  # noqa: E731
    stack = TenantStack(model, device="cpu")
    stack.add_tenant("a")
    stack.add_tenant("b")
    before = snap()
    cap = ring.device_cap
    for bad in (cap + 1, -1):
        dev = np.full((2, 4), cap, np.int32)
        dev[1, 0] = bad
        with pytest.raises(IndexError):
            ring.update_and_score(model, stack.stacked, dev,
                                  np.zeros((2, 4), np.float32))
    with pytest.raises(ValueError):
        ring.update_and_score(model, stack.stacked,
                              np.full((3, 4), cap, np.int32),
                              np.zeros((3, 4), np.float32))
    for k, v in before.items():
        torch.testing.assert_close(snap()[k], v)
    assert not ring.faulted


# -- TenantStack (tests/test_multitenant.py's cases) --------------------------


def test_tenant_stack_matches_per_tenant_and_jax_scoring():
    """The stack's query path: each slot scores like the model alone on
    that tenant's params (1e-5) and like the JAX stack (3e-2)."""
    jmodel = jax_build("lstm", window=16, hidden=8)
    model = _model("lstm", window=16, hidden=8)
    jstack = JStack(jmodel, mesh=None)
    stack = TenantStack(model, device="cpu")
    params = {t: jax.tree.map(np.asarray,
                              jmodel.init(jax.random.PRNGKey(10 + i)))
              for i, t in enumerate("abc")}
    for t, p in params.items():
        jstack.add_tenant(t, p)
        stack.add_tenant(t, params_from_numpy(p, "cpu"))
    assert stack.capacity == jstack.capacity == 4
    rng = np.random.default_rng(0)
    x = rng.normal(20.0, 2.0, (32, 16)).astype(np.float32)
    v = np.ones((32, 16), bool)
    v[:4, :10] = False
    xs = np.broadcast_to(x, (4, *x.shape)).copy()
    vs = np.broadcast_to(v, (4, *v.shape)).copy()
    got = stack.score(xs, vs).numpy()
    want = np.asarray(jstack.score(xs, vs))
    for t, p in params.items():
        slot = stack.slots[t]
        alone = model.score(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                            torch.from_numpy(v)).numpy()
        np.testing.assert_allclose(got[slot], alone, atol=1e-5)
        np.testing.assert_allclose(got[slot], want[jstack.slots[t]],
                                   atol=3e-2)


def test_tenant_stack_swap_grow_and_slot_reuse():
    model = _model("lstm", window=16, hidden=8)
    stack = TenantStack(model, device="cpu")
    stack.add_tenant("a")
    stack.add_tenant("b")
    assert stack.capacity == 2
    stack.add_tenant("c")  # crosses pow2 → grow
    assert (stack.capacity, stack.rebuilds) == (4, 3)
    p_new = model.init(torch.Generator().manual_seed(99))
    assert stack.versions["b"] == 0
    fence = stack.fence
    assert stack.set_params("b", p_new) == 1
    assert stack.fence == fence + 1
    got = stack.get_params("b")
    torch.testing.assert_close(got["lstm0"]["wh"], p_new["lstm0"]["wh"])
    # the clone is the caller's: writing it leaves the stack alone
    got["lstm0"]["wh"].zero_()
    torch.testing.assert_close(stack.get_params("b")["lstm0"]["wh"],
                               p_new["lstm0"]["wh"])
    slot_b = stack.slots["b"]
    stack.remove_tenant("b")
    assert stack.add_tenant("d") == slot_b  # freed slot reused
    assert stack.capacity == 4
    # the reused slot is reset to init params, not b's swapped-in weights
    got_d = stack.get_params("d")
    torch.testing.assert_close(got_d["lstm0"]["wh"],
                               stack._init_params["lstm0"]["wh"])
    assert stack.occupancy().tolist() == [True, True, True, False]


def test_mesh_is_refused_not_ignored():
    """Something that is not a mesh is refused, never dropped; a mesh of
    another device type than the stack's is refused too (a meshed pool
    is held in tests/test_torch_mesh.py)."""
    from sitewhere_tpu_torch.parallel.mesh import Mesh

    model = _model("lstm-stream")
    with pytest.raises(TypeError, match="mesh"):
        TenantStack(model, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        SharedScoringPool(model, MetricsRegistry(), mesh=object(),
                          device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        TenantStack(model, mesh=Mesh([["meta"]]), device="cpu")
    pool = _pool(model)
    assert pool.mesh_stats()["devices"] == 0
    assert pool.mesh_stats()["shape"] == {}


# -- pool behaviour (tests/test_megabatch.py and tests/test_streaming.py) -----


def test_shared_pool_flushes_all_tenants_in_one_call(run):
    async def main():
        pool = _pool(_model("zscore"), batch_buckets=(16, 64))
        delivered: dict = {}
        sims, stores = {}, {}
        # c's threshold sits above the zscore clip (50) → never alerts
        for tid, thr in [("a", 4.0), ("b", 4.0), ("c", 51.0)]:
            stores[tid], sims[tid], _ = _tenant(pool, tid, 20, 5, delivered,
                                                threshold=thr, ticks=20)
        await wait_until(lambda: pool.ready, timeout=30.0)
        for tid, sim in sims.items():
            sim.cfg = SimConfig(num_devices=20, seed=5, anomaly_rate=1.0,
                                anomaly_magnitude=30.0)
            batch, truth = sim.tick(t=21 * 60.0)
            assert truth.all()
            pool.admit(tid, batch)
        rounds = pool.flush_rounds.value
        await wait_until(lambda: all(delivered.values()), timeout=10.0)
        assert pool.flush_rounds.value == rounds + 1
        a, b, c = (delivered[t][0] for t in "abc")
        assert len(a) == len(b) == len(c) == 20
        assert a.is_anomaly.all() and b.is_anomaly.all()
        assert not c.is_anomaly.any()
        pool.close()

    run(main())


def test_param_hot_swap_version_fence(run):
    """A swap landing after dispatch but before settle does not steal the
    in-flight megabatch's attribution: the settled batch carries the
    version snapshotted at dispatch."""

    async def main():
        model = _model("lstm", window=16, hidden=8)
        pool = _pool(model, batch_buckets=(32,), batch_window_ms=50.0)
        delivered: list = []

        async def deliver(scored):
            delivered.append(scored)

        slot = pool.register("a", TelemetryStore(history=32), 6.0, deliver)
        await wait_until(lambda: pool.ready, timeout=30.0)
        fence0 = pool.stack.fence
        # admit + dispatch in one loop step, so the flusher cannot race
        slot.admit(_batch("a"))
        pool._flush_round()
        assert slot.swap_params(
            model.init(torch.Generator().manual_seed(7))) == 1
        assert pool.stack.fence > fence0
        await wait_until(lambda: len(delivered) == 1, timeout=30.0)
        assert delivered[0].model_version == 0
        slot.admit(_batch("a", t=11.0))
        pool._flush_round()
        await wait_until(lambda: len(delivered) == 2, timeout=30.0)
        assert delivered[1].model_version == 1
        pool.close()

    run(main())


def test_tenant_add_remove_under_load(run):
    async def main():
        metrics = MetricsRegistry()
        pool = SharedScoringPool(_model("zscore"), metrics,
                                 PoolConfig(batch_buckets=(32,),
                                            batch_window_ms=0.5),
                                 device="cpu")
        got: dict[str, int] = {}

        def deliver_for(tid):
            async def deliver(scored):
                got[tid] = got.get(tid, 0) + len(scored)
            return deliver

        for tid in ("a", "b"):
            pool.register(tid, TelemetryStore(history=32), 6.0,
                          deliver_for(tid))
        await wait_until(lambda: pool.ready, timeout=30.0)
        for tid in ("a", "b"):
            pool.admit(tid, _batch(tid))
        pool._flush_round()  # in flight for a+b
        # register c mid-flight: the stack grows 2 → 4 (a rebuild), the
        # in-flight settle still lands
        pool.register("c", TelemetryStore(history=32), 6.0, deliver_for("c"))
        assert pool.stack.capacity == 4
        assert metrics.counter("scoring.stack_rebuilds").value >= 1
        assert pool.stack.occupancy().sum() == 3
        await wait_until(lambda: got.get("a") == 8 and got.get("b") == 8,
                         timeout=30.0)
        await wait_until(lambda: pool.ready, timeout=30.0)
        # unregister b WITH pending: its events are accounted dropped
        pool.admit("b", _batch("b", t=20.0))
        assert pool.tenants["b"].pending_n == 8
        pool.unregister("b")
        assert metrics.counter("scoring.admissions_dropped").value >= 8
        assert pool.stack.occupancy().sum() == 2
        for tid in ("a", "c"):
            pool.admit(tid, _batch(tid, t=21.0))
        pool._flush_round()
        await wait_until(lambda: got.get("a") == 16 and got.get("c") == 8,
                         timeout=30.0)
        assert "b" not in pool.stack.slots
        pool.close()

    run(main())


def test_reused_slot_does_not_leak_state_or_weights(run):
    """A streaming tenant's slot, freed and reused by a tenant with no
    history, starts from cold state and init weights."""

    async def main():
        model = _model("lstm-stream")
        pool = _pool(model)
        delivered: dict = {}
        _tenant(pool, "a", 20, 1, delivered)
        _tenant(pool, "b", 20, 2, delivered,
                params=model.init(torch.Generator().manual_seed(5)))
        await wait_until(lambda: pool.ready, timeout=30.0)
        slot_b = pool.stack.slots["b"]
        assert pool.ring.state["count"][slot_b, :20].min() >= 8
        pool.unregister("b")
        delivered["d"] = []

        async def deliver(scored):
            delivered["d"].append(scored)

        pool.register("d", TelemetryStore(history=64), 4.0, deliver)
        assert pool.stack.slots["d"] == slot_b
        cold = model.init_state(pool.ring.device_cap + 1)
        for k, leaf in pool.ring.state.items():
            torch.testing.assert_close(leaf[slot_b], cold[k])
        torch.testing.assert_close(pool.stack.get_params("d")["lstm0"]["wh"],
                                   pool.stack._init_params["lstm0"]["wh"])
        pool.close()

    run(main())


def test_max_tenants_bounds_each_dispatch(run):
    async def main():
        pool = _pool(_model("zscore"), batch_buckets=(32,),
                     batch_window_ms=50.0, max_tenants=2)
        got: dict[str, int] = {}

        def deliver_for(tid):
            async def deliver(scored):
                got[tid] = got.get(tid, 0) + len(scored)
            return deliver

        tids = ("a", "b", "c", "d")
        for tid in tids:
            pool.register(tid, TelemetryStore(history=32), 6.0,
                          deliver_for(tid))
        await wait_until(lambda: pool.ready, timeout=30.0)
        for tid in tids:
            pool.admit(tid, _batch(tid))
        pool._flush_round()   # packs 2 tenants, re-arms the wake
        pool._flush_round()   # the other 2
        assert pool.megabatch_tenants._max <= 2.0
        await wait_until(lambda: all(got.get(t) == 8 for t in tids),
                         timeout=30.0)
        assert pool._total_pending == 0
        pool.close()

    run(main())


def test_pool_streaming_swap_params_reseeds_slot(run):
    """A checkpoint rollout on ONE pooled tenant reseeds only that
    tenant's streaming state, to what a dedicated session born with the
    new weights seeds; its neighbour is untouched."""

    async def main():
        model = _model("lstm-stream")
        pool = _pool(model)
        delivered: dict = {}
        stores, slots = {}, {}
        for i, tid in enumerate(("a", "b")):
            stores[tid], _, slots[tid] = _tenant(pool, tid, 25, i + 30,
                                                 delivered)
        await wait_until(lambda: pool.ready, timeout=30.0)
        sa, sb = pool.stack.slots["a"], pool.stack.slots["b"]
        pred_a0 = pool.ring.state["pred"][sa, :25].clone()
        pred_b0 = pool.ring.state["pred"][sb, :25].clone()
        new_params = model.init(torch.Generator().manual_seed(99))
        assert slots["a"].swap_params(new_params) == 1
        pred_a1 = pool.ring.state["pred"][sa, :25]
        assert (pred_a1 - pred_a0).abs().max() > 1e-3
        ref = ScoringSession(_model("lstm-stream"), stores["a"],
                             MetricsRegistry(), ScoringConfig(buckets=(64,)),
                             params=new_params, device="cpu")
        ref.warmup()
        np.testing.assert_allclose(pred_a1.numpy(),
                                   ref.ring.state["pred"][:25].numpy(),
                                   atol=1e-5)
        torch.testing.assert_close(pool.ring.state["pred"][sb, :25], pred_b0,
                                   atol=0.0, rtol=0.0)
        ref.close()
        pool.close()

    run(main())


def test_pool_regrow_keeps_state(run):
    """An event for a device past the ring's capacity holds the flush,
    grows the device axis off the hot path and re-warms; every tenant's
    state survives and the held events then score."""

    async def main():
        pool = _pool(_model("lstm-stream"))
        delivered: dict = {}
        _tenant(pool, "a", 20, 1, delivered)
        _tenant(pool, "b", 20, 2, delivered)
        await wait_until(lambda: pool.ready, timeout=30.0)
        cap = pool.ring.device_cap
        before = {k: v[:, :20].clone() for k, v in pool.ring.state.items()}
        far = MeasurementBatch(BatchContext(tenant_id="a"),
                               np.array([3, cap + 7], np.uint32),
                               np.zeros(2, np.uint16),
                               np.full(2, 20.0, np.float32), np.zeros(2))
        pool.admit("a", far)
        pool._deadline = 0.0  # due now
        assert pool.flush_nowait() is False  # grew, warmup restarted
        assert pool.ring.device_cap > cap + 7 and not pool.ready
        for k, v in before.items():
            torch.testing.assert_close(pool.ring.state[k][:, :20], v)
        await wait_until(lambda: len(delivered["a"]) == 1, timeout=30.0)
        assert len(delivered["a"][0]) == 2
        assert not delivered["b"]
        pool.close()

    run(main())


def test_pool_fault_recovery_reseeds_from_host(run):
    """A stacked dispatch that fails drops its events (counted), rebuilds
    the ring and reseeds every tenant from its host store; the pool then
    scores again."""

    async def main():
        pool = _pool(_model("lstm-stream"))
        delivered: dict = {}
        sims = {}
        for i, tid in enumerate(("a", "b")):
            _, sims[tid], _ = _tenant(pool, tid, 20, i + 1, delivered)
        await wait_until(lambda: pool.ready, timeout=30.0)
        seeded = {k: v.clone() for k, v in pool.ring.state.items()}
        ring = pool.ring

        def boom(*a):
            raise RuntimeError("injected device fault")

        ring._step = boom
        for tid in ("a", "b"):
            pool.admit(tid, sims[tid].tick(t=60.0 * (W + 4))[0])
        pool._flush_round()
        assert pool.dropped.value == 40
        assert pool.ring is not ring and not pool.ready
        for k, v in seeded.items():  # scratch rows aside
            torch.testing.assert_close(pool.ring.state[k][:, :-1], v[:, :-1])
        await wait_until(lambda: pool.ready, timeout=30.0)
        for tid in ("a", "b"):
            pool.admit(tid, sims[tid].tick(t=60.0 * (W + 5))[0])
        await wait_until(lambda: all(len(delivered[t]) == 1
                                     for t in ("a", "b")), timeout=30.0)
        pool.close()

    run(main())


def test_settle_task_retained_until_delivery(run):
    """The in-flight settle task is strongly referenced (the loop keeps
    only a weak one) until its delivery is done."""

    async def main():
        pool = _pool(_model("zscore"), batch_buckets=(32,),
                     batch_window_ms=50.0)
        delivered: list = []

        async def deliver(scored):
            delivered.append(scored)

        slot = pool.register("a", TelemetryStore(history=32), 6.0, deliver)
        await wait_until(lambda: pool.ready, timeout=30.0)
        slot.admit(_batch("a"))
        pool._flush_round()
        assert len(pool._settle_tasks) == 1
        await wait_until(lambda: len(delivered) == 1, timeout=30.0)
        await wait_until(lambda: not pool._settle_tasks, timeout=5.0)
        await asyncio.sleep(0)
        pool.close()

    run(main())
