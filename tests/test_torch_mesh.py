"""The port's mesh (`sitewhere_tpu_torch/parallel/mesh.py`) and the paths
that shard over it, against the JAX package's on its 8-device CPU mesh
(`tests/conftest.py`), mirroring `tests/test_mesh_serving.py`:

- `mesh_from_spec` fits a spec to the devices there are exactly as the
  reference does, and degrades to meshless on one device with its
  warning;
- tenant- and instance-level wiring (`rule-processing: {mesh}`,
  `scoring_mesh_data/model`) reach the shared pool; the CPU's mesh
  width is the instance's `cpu_mesh_devices` (logical CPU devices);
- mesh on/off equivalence over 8 logical devices as `{data: 4, model:
  2}`: the scored pipeline equals the port's meshless run exactly and
  the JAX pipeline on its 8-device mesh within the parity tolerance of
  `tests/test_torch_pipeline.py`; the pool alone, with replicas on two
  device keys, equals the meshless pool exactly;
- sharded hot-swap and add/remove: a swap writes only its shard, the
  version fence holds, growth re-cuts the shards, a reused slot leaks
  nothing;
- the `scoring.mesh` chaos seam quarantines the admitting record;
- the counterpart of `__graft_entry__.py`'s `dryrun_multichip` (6
  tenants; lstm, sequence-parallel longwin, tft and GNN steps) held to
  the JAX dryrun's numbers where no randomness is drawn.
"""

import asyncio
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.parallel.mesh import mesh_from_spec as jax_mesh_from_spec
from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.domain.model import DeviceType
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.kernel.service import ServiceRuntime
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_devices,
    mesh_from_spec,
)
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from sitewhere_tpu_torch.services import (
    DeviceManagementService,
    DeviceStateService,
    EventManagementService,
    EventSourcesService,
    InboundProcessingService,
    RuleProcessingService,
)
from tests import test_torch_pipeline as parity
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

MESH = {"data": 4, "model": 2}
CPU8 = ["cpu"] * 8


# -- fit / wiring ----------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    MESH, {"data": 8, "model": 2}, {"data": 16, "model": 16},
    {"model": 4}, {"data": 2, "model": 2}, None, {}])
def test_mesh_from_spec_fits_as_the_reference(spec):
    assert jax.device_count() == 8  # the conftest contract
    want = jax_mesh_from_spec(spec)
    got = mesh_from_spec(spec, CPU8)
    if want is None:
        assert got is None
    else:
        assert dict(got.shape) == dict(want.shape)
        assert got.size == want.size


def test_mesh_from_spec_on_one_device_runs_meshless_loudly(caplog):
    with caplog.at_level(logging.WARNING,
                         logger="sitewhere_tpu_torch.parallel.mesh"):
        assert mesh_from_spec(MESH, ["cpu"]) is None
    assert any("running meshless" in r.getMessage() for r in caplog.records)
    caplog.clear()
    with caplog.at_level(logging.WARNING,
                         logger="sitewhere_tpu_torch.parallel.mesh"):
        fit = mesh_from_spec({"data": 8, "model": 2}, CPU8)
    assert dict(fit.shape) == {"data": 4, "model": 2}
    assert any("fitting" in r.getMessage() for r in caplog.records)


def test_mesh_devices_and_shape_read_as_in_jax():
    assert mesh_devices("cpu", 3) == [torch.device("cpu")] * 3
    assert mesh_devices("cpu") == [torch.device("cpu")]
    mesh = make_mesh(data=4, model=2, devices=CPU8)
    assert dict(mesh.shape) == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.axis_devices("model") == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="devices"):
        make_mesh(data=3, model=2, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh_devices()


async def _runtime(faults=None, tenants=("t0", "t1"), rule_extra=None,
                   **settings):
    rt = ServiceRuntime(InstanceSettings(device="cpu", **settings))
    for cls in (DeviceManagementService, EventSourcesService,
                InboundProcessingService, EventManagementService,
                DeviceStateService, RuleProcessingService):
        rt.add_service(cls(rt))
    if faults is not None:
        rt.install_faults(faults)
    await rt.start()
    rule = {"model": "zscore", "model_config": {"window": 16},
            "threshold": 6.0, "batch_window_ms": 1.0, "buckets": [256],
            "capacity": 256, "megabatch": {"enabled": True},
            **(rule_extra or {})}
    for tid in tenants:
        await rt.add_tenant(TenantConfig(
            tenant_id=tid, sections={"rule-processing": rule}))
        rt.api("device-management").management(tid).bootstrap_fleet(
            DeviceType(token="thermo", name="T"), 32)
    for tid in tenants:
        slot = rt.api("rule-processing").engine(tid).pool_slot
        await wait_until(lambda s=slot: s.ready, timeout=60.0)
    return rt


def test_mesh_wiring_tenant_and_instance(run):
    async def main():
        rt = await _runtime(rule_extra={"mesh": dict(MESH)},
                            cpu_mesh_devices=8)
        try:
            pool = rt.api("rule-processing").engine("t0").pool_slot.pool
            assert dict(pool.mesh.shape) == MESH
            assert rt.metrics.gauge("scoring.mesh_devices:zscore").value == 8
            # stacked params and ring: one block a mesh position
            assert set(pool.stack.stacked) == set(pool.mesh.positions())
            assert set(pool.ring.rings) == set(pool.mesh.positions())
            # one ring a (model shard, device): 2 shards on the one CPU
            assert len(pool.ring._distinct()) == 2
            stats = pool.mesh_stats()
            assert stats["devices"] == 8 and stats["shape"] == MESH
            # the telemetry beat's mesh block (what a fleet worker's
            # heartbeat and the observer's occupancy matrix read)
            sample = rt.beat.sample(loop_lag_s=0.0)
            block = next(b for b in sample["mesh"] if b["model"] == "zscore")
            assert block["devices"] == 8 and block["shape"] == MESH
            assert block["row_occupancy"] == 1.0   # 2 tenants, 2 rows
        finally:
            await rt.stop()
        # instance-level defaults reach tenants with no mesh override
        rt = await _runtime(tenants=("solo",), scoring_mesh_data=4,
                            scoring_mesh_model=2, cpu_mesh_devices=8)
        try:
            pool = rt.api("rule-processing").engine("solo").pool_slot.pool
            assert dict(pool.mesh.shape) == MESH
        finally:
            await rt.stop()
        # the CPU's default width is one device: the spec degrades
        rt = await _runtime(tenants=("one",), rule_extra={"mesh": MESH})
        try:
            pool = rt.api("rule-processing").engine("one").pool_slot.pool
            assert pool.mesh is None and pool.mesh_stats()["devices"] == 0
            assert rt.metrics.gauge("scoring.mesh_devices:zscore").value == 0
        finally:
            await rt.stop()

    run(main())


# -- mesh on/off equivalence ---------------------------------------------------------

@pytest.mark.parametrize("case", ["zscore-megabatch", "lstm-stream-pool"])
def test_mesh_on_off_score_equivalence(run, case):
    """The acceptance pair over 8 logical CPU devices as {data: 4,
    model: 2}: the meshed pipeline equals the meshless one exactly
    (scores, alerts, totals, committed offsets, device state), and the
    JAX pipeline on its 8-device mesh within the parity tolerance."""
    weights = parity._weights(case)
    mesh = {"mesh": dict(MESH)}
    on = run(parity._drive(parity.PORT_PKG, case, weights, port=True,
                           settings={"cpu_mesh_devices": 8},
                           rule_extra=mesh))
    off = run(parity._drive(parity.PORT_PKG, case, weights, port=True))
    assert on == off
    want = run(parity._drive(parity.JAX_PKG, case, weights, port=False,
                             rule_extra=mesh))
    parity.assert_same_pipeline(case, want, on)


def _batch(tid, n, t, rng):
    return MeasurementBatch(
        BatchContext(tenant_id=tid, source="test"),
        rng.permutation(n).astype(np.uint32), np.zeros(n, np.uint16),
        rng.normal(20.0, 2.0, n).astype(np.float32), np.full(n, float(t)))


async def _pool_run(name, mesh, readback="full", ticks=20):
    """Three tenants through a pool, each tick's devices in a shuffled
    order (so a device's column, hence its data shard, moves between
    ticks); returns {tenant: (device ids, scores)}."""
    cfg = dict(window=16) if name == "zscore" else dict(window=16, hidden=8)
    model = build_model(name, device="cpu", **cfg)
    pool = SharedScoringPool(model, MetricsRegistry(), PoolConfig(
        batch_buckets=(32,), batch_window_ms=5.0, score_dtype="float32",
        readback=readback), mesh=mesh, device="cpu")
    got: dict = {}

    def deliver_for(tid):
        async def deliver(sb):
            got.setdefault(tid, []).append(
                (sb.device_index.copy(), sb.score.copy()))
        return deliver

    for i in range(3):
        pool.register(f"t{i}", TelemetryStore(history=32),
                      2.0 if readback == "anomalies" else 6.0,
                      deliver_for(f"t{i}"))
    try:
        await wait_until(lambda: pool.ready, timeout=60.0)
        rng = np.random.default_rng(0)
        for k in range(ticks):
            for i in range(3):
                pool.admit(f"t{i}", _batch(f"t{i}", 24, 10.0 + k, rng))
            while pool._total_pending:
                pool.flush_nowait()
                await asyncio.sleep(0.005)
            await pool.drain()
        return {tid: (np.concatenate([d for d, _ in v]),
                      np.concatenate([s for _, s in v]))
                for tid, v in got.items()}
    finally:
        pool.close()


@pytest.mark.parametrize("name,readback", [
    ("lstm-stream", "full"), ("lstm-stream", "anomalies"), ("lstm", "full"),
    ("zscore", "full")])
def test_pool_replicas_on_two_device_keys_score_as_meshless(run, name,
                                                            readback):
    """Each model shard replicated on two device keys (`cpu`, `cpu:0`):
    every dispatch copies each block's touched rows to the other
    replica, so a device whose column moves to the other data shard
    finds its state there."""
    mesh = make_mesh(data=2, model=2,
                     devices=["cpu", "cpu", "cpu:0", "cpu:0"])
    on = run(_pool_run(name, mesh, readback))
    off = run(_pool_run(name, None, readback))
    assert on.keys() == off.keys()
    for tid in off:
        np.testing.assert_array_equal(on[tid][0], off[tid][0])
        np.testing.assert_array_equal(on[tid][1], off[tid][1])
    if readback == "anomalies":
        assert sum(v[0].shape[0] for v in off.values()) > 0


# -- hot-swap + add/remove under a sharded stack ---------------------------------

def test_sharded_hot_swap_and_add_remove(run):
    async def main():
        metrics = MetricsRegistry()
        model = build_model("lstm", device="cpu", window=16, hidden=8)
        mesh = mesh_from_spec(MESH, CPU8)
        pool = SharedScoringPool(model, metrics, PoolConfig(
            batch_buckets=(32,), batch_window_ms=50.0), mesh=mesh,
            device="cpu")
        got: dict = {}
        delivered: list = []

        def deliver_for(tid):
            async def deliver(scored):
                got[tid] = got.get(tid, 0) + len(scored)
            return deliver

        async def capture(scored):
            delivered.append(scored)

        rng = np.random.default_rng(1)
        try:
            pool.register("a", TelemetryStore(history=32), 6.0, capture)
            pool.register("b", TelemetryStore(history=32), 6.0,
                          deliver_for("b"))
            await wait_until(lambda: pool.ready, timeout=60.0)
            assert pool.stack.capacity == 2       # a model-axis multiple
            assert set(pool.stack.stacked) == set(mesh.positions())
            # dispatch, then swap mid-flight: the settled batch carries
            # the dispatch-time version (the fence)
            pool.admit("a", _batch("a", 8, 10.0, rng))
            pool._flush_round()
            other = pool.stack.stacked[(0, 1)]    # b's shard, untouched
            before = {k: v.clone() for k, v in other["lstm0"].items()}
            fence = pool.stack.fence
            new = model.init(torch.Generator().manual_seed(7))
            assert pool.stack.set_params("a", new) == 1
            assert pool.stack.fence == fence + 1
            for k, v in other["lstm0"].items():
                assert torch.equal(v, before[k]), k
            torch.testing.assert_close(pool.stack.get_params("a")["lstm0"]
                                       ["wh"], new["lstm0"]["wh"])
            await wait_until(lambda: len(delivered) == 1, timeout=60.0)
            assert delivered[0].model_version == 0
            # grow: a third tenant crosses capacity 2 → 4, re-cut
            rebuilds = pool.stack.rebuilds
            pool.register("c", TelemetryStore(history=32), 6.0,
                          deliver_for("c"))
            assert pool.stack.capacity == 4
            assert pool.stack.rebuilds == rebuilds + 1
            assert metrics.counter("scoring.stack_rebuilds").value >= 1
            assert pool.ring.t_cap == 4
            # a's swapped weights survived the re-cut
            torch.testing.assert_close(pool.stack.get_params("a")["lstm0"]
                                       ["wh"], new["lstm0"]["wh"])
            await wait_until(lambda: pool.ready, timeout=60.0)
            # remove b (pending counted dropped); a reused slot is reset
            pool.admit("b", _batch("b", 8, 20.0, rng))
            slot_b = pool.stack.slots["b"]
            pool.unregister("b")
            assert metrics.counter("scoring.admissions_dropped").value >= 8
            pool.register("d", TelemetryStore(history=32), 6.0,
                          deliver_for("d"))
            assert pool.stack.slots["d"] == slot_b
            torch.testing.assert_close(
                pool.stack.get_params("d")["lstm0"]["wh"],
                pool.stack._init_params["lstm0"]["wh"])
            await wait_until(lambda: pool.ready, timeout=60.0)
            for tid in ("a", "c"):
                pool.admit(tid, _batch(tid, 8, 21.0, rng))
            pool._flush_round()
            await wait_until(lambda: len(delivered) == 2
                             and got.get("c") == 8, timeout=60.0)
            assert delivered[1].model_version == 1  # post-swap
        finally:
            pool.close()

    run(main())


# -- the chaos seam -------------------------------------------------------------------

def test_mesh_chaos_quarantines_with_provenance(run):
    """An injected `scoring.mesh` fault at admission dead-letters the
    admitting record; the sharded pool survives and later records score
    normally."""
    async def main():
        from sitewhere_tpu_torch.kernel.bus import TopicNaming
        from sitewhere_tpu_torch.kernel.dlq import list_dead_letters
        from sitewhere_tpu_torch.kernel.faults import FaultInjector

        fi = FaultInjector(seed=9)
        rt = await _runtime(faults=fi, tenants=("t0",),
                            rule_extra={"mesh": dict(MESH)},
                            cpu_mesh_devices=8)
        try:
            assert rt.api("rule-processing").engine(
                "t0").pool_slot.pool.mesh is not None
            fi.arm("scoring.mesh", rate=1.0, max_faults=1)
            decoded = rt.naming.tenant_topic(
                "t0", TopicNaming.EVENT_SOURCE_DECODED)
            dlq = rt.naming.tenant_topic("t0", TopicNaming.DEAD_LETTER)
            rng = np.random.default_rng(2)
            await rt.bus.produce(decoded, _batch("t0", 16, 1000.0, rng),
                                 key="gw")
            await wait_until(
                lambda: len(list_dead_letters(rt.bus, dlq)) >= 1,
                timeout=15.0)
            entries = list_dead_letters(rt.bus, dlq)
            assert entries[0][1]["original_topic"] == decoded
            scored_topic = rt.naming.tenant_topic(
                "t0", TopicNaming.SCORED_EVENTS)
            consumer = rt.bus.subscribe(scored_topic, group="mesh-ch-m")
            await rt.bus.produce(decoded, _batch("t0", 16, 1060.0, rng),
                                 key="gw")
            seen: list = []

            def collect():
                seen.extend(consumer.poll_nowait(max_records=64))
                return sum(len(r.value) for r in seen) >= 16
            await wait_until(collect, timeout=15.0)
            consumer.close()
        finally:
            await rt.stop()

    run(main())


# -- the dryrun_multichip counterpart -------------------------------------------------

def _jax_stacked(n_tenants):
    from sitewhere_tpu.models.lstm import LstmAnomalyModel, LstmConfig

    jm = LstmAnomalyModel(LstmConfig(window=16, hidden=8))
    plist = [jm.init(jax.random.PRNGKey(i)) for i in range(n_tenants)]
    return jm, jax.tree.map(lambda *a: np.asarray(jnp.stack(a)), *plist)


def test_dryrun_multichip_counterpart():
    """`__graft_entry__.py` `dryrun_multichip(8)` on the port: a
    {data: 4, model: 2} mesh of 6 tenants (3 a model shard), one
    multi-tenant training step and scoring, the pooled streaming ring
    dense and sparse, a sequence-parallel longwin step over an 8-way
    axis, a data-parallel TFT train and a node-sharded GNN train. Held
    to the JAX package's numbers on the same params and data (bf16
    compute on both sides: the documented scan rounding, 1e-2)."""
    from sitewhere_tpu.models.longwin import LongWindowConfig as JLwCfg
    from sitewhere_tpu.models.longwin import LongWindowModel as JLw
    from sitewhere_tpu.models.tft import TftConfig as JTftCfg
    from sitewhere_tpu.models.tft import TftForecaster as JTft
    from sitewhere_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sitewhere_tpu.training.trainer import Trainer as JTrainer
    from sitewhere_tpu.training.trainer import TrainerConfig as JTrainerCfg
    from sitewhere_tpu_torch.models.lstm import LstmAnomalyModel, LstmConfig
    from sitewhere_tpu_torch.models.lstm import StreamingLstmModel
    from sitewhere_tpu_torch.models.longwin import (
        LongWindowConfig,
        LongWindowModel,
    )
    from sitewhere_tpu_torch.models.tft import TftConfig, TftForecaster
    from sitewhere_tpu_torch.parallel.mesh import (
        Mesh,
        megabatch_placer,
        place_tree,
        tenant_placer,
    )
    from sitewhere_tpu_torch.scoring.stream import (
        MeshRing,
        StackedStreamingRing,
    )
    from sitewhere_tpu_torch.training.trainer import Trainer, TrainerConfig

    n = 8
    mesh = make_mesh(data=n // 2, model=2, devices=["cpu"] * n)
    n_tenants, per_tenant_batch, w = 6, 4 * 4, 16
    jm, stacked_np = _jax_stacked(n_tenants)
    model = LstmAnomalyModel(LstmConfig(window=16, hidden=8), device="cpu")
    x = np.random.default_rng(0).normal(
        20.0, 2.0, (n_tenants, per_tenant_batch, w)).astype(np.float32)
    v = np.ones_like(x, dtype=bool)

    # multi-tenant training step: per-tenant loss, mean over tenants
    master = {k: {n2: t.requires_grad_(True) for n2, t in d.items()}
              for k, d in params_from_numpy(stacked_np, "cpu").items()}
    place = megabatch_placer(mesh)
    xs, vs = place(torch.from_numpy(x)), place(torch.from_numpy(v))
    blocks = place_tree(master, tenant_placer(mesh), mesh)
    loss = sum(torch.func.vmap(model.loss)(blocks[pos], xs.blocks[pos],
                                           vs.blocks[pos]).sum()
               for pos in mesh.positions()) / (n_tenants * mesh.shape["data"])
    want_loss = float(jnp.mean(jax.vmap(jm.loss)(stacked_np, x, v)))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-2)
    opt = torch.optim.Adam(jax.tree.leaves(master, is_leaf=torch.is_tensor),
                           lr=1e-3)
    loss.backward()
    opt.step()
    new = jax.tree.map(torch.Tensor.detach, master, is_leaf=torch.is_tensor)
    blocks = place_tree(new, tenant_placer(mesh), mesh)
    scores = {pos: torch.func.vmap(model.score)(blocks[pos], xs.blocks[pos],
                                                vs.blocks[pos])
              for pos in mesh.positions()}
    from sitewhere_tpu_torch.parallel.mesh import assemble

    scores = assemble(mesh, scores, (n_tenants, per_tenant_batch))
    assert scores.shape == (n_tenants, per_tenant_batch)
    assert torch.isfinite(scores).all()

    # the pooled streaming ring over the mesh, dense and sparse
    s_model = StreamingLstmModel(LstmConfig(window=16, hidden=8),
                                 device="cpu")

    def make(rows, cap, device, dtype):
        return StackedStreamingRing(s_model, rows, device_cap=cap,
                                    score_dtype=dtype, device=device)

    dev_ids = np.tile(np.arange(8, dtype=np.int32)[None], (n_tenants, 1))
    vals = np.random.default_rng(3).normal(
        20.0, 2.0, (n_tenants, 8)).astype(np.float32)
    ring = MeshRing(mesh, make, n_tenants, device_cap=32)
    s_scores = ring.update_and_score(s_model, new, dev_ids, vals)
    assert s_scores.shape == (n_tenants, 8)
    assert torch.isfinite(s_scores).all()
    sparse = MeshRing(mesh, make, n_tenants, device_cap=32, sparse=True,
                      sparse_k=4)
    n_anom, pos, topv = sparse.update_and_score(
        s_model, new, dev_ids, vals,
        thresholds=np.full(n_tenants, 4.0, np.float32))
    assert n_anom.shape == (n_tenants,)
    assert pos.shape == (n_tenants, 4) and topv.shape == (n_tenants, 4)

    # sequence parallelism: the time axis over an 8-way axis
    seq_mesh = Mesh(np.array(["cpu"] * n, dtype=object), ("data",))
    j_seq = jax.sharding.Mesh(np.asarray(jax.devices()[:n]), ("data",))
    sp = dict(window=16 * n, hidden=8, heads=2, layers=1, seq_axis="data")
    j_sp = JLw(JLwCfg(**sp), mesh=j_seq)
    sp_model = LongWindowModel(LongWindowConfig(**sp), mesh=seq_mesh,
                               device="cpu")
    sp_np = jax.tree.map(np.asarray, j_sp.init(jax.random.PRNGKey(7)))
    xw = np.random.default_rng(1).normal(
        10.0, 1.0, (2, sp["window"])).astype(np.float32)
    vw = np.ones_like(xw, dtype=bool)
    sp_params = jax.tree.map(lambda t: t.requires_grad_(True),
                             params_from_numpy(sp_np, "cpu"),
                             is_leaf=torch.is_tensor)
    sp_loss = sp_model.loss(sp_params, torch.from_numpy(xw),
                            torch.from_numpy(vw))
    j_loss = jax.jit(j_sp.loss)(sp_np, xw, vw)
    np.testing.assert_allclose(float(sp_loss.detach()), float(j_loss),
                               rtol=1e-2)
    sp_loss.backward()
    # (the q/k/v biases are unused, as in the reference: no gradient)
    stepped = jax.tree.map(
        lambda t: (t if t.grad is None else t - 1e-3 * t.grad).detach(),
        sp_params, is_leaf=torch.is_tensor)
    sp_scores = sp_model.score(stepped, torch.from_numpy(xw),
                               torch.from_numpy(vw))
    assert sp_scores.shape == (2,) and torch.isfinite(sp_scores).all()

    # TFT: a data-parallel train over the full mesh's 8 data devices
    tft_cfg = dict(window=16, horizon=4, hidden=8, heads=2)
    j_tft = JTft(JTftCfg(**tft_cfg))
    tft = TftForecaster(TftConfig(**tft_cfg), device="cpu")
    tft_np = jax.tree.map(np.asarray, j_tft.init(jax.random.PRNGKey(4)))
    xt = np.random.default_rng(2).normal(
        5.0, 1.0, (8 * n, 16)).astype(np.float32)
    vt = np.ones_like(xt, dtype=bool)
    tcfg = dict(batch_size=4 * n, steps=2, log_every=1)
    _, j_report = JTrainer(j_tft, JTrainerCfg(**tcfg), mesh=jmake_mesh(
        data=n, model=1, devices=jax.devices()[:n])).train(
        xt, vt, params=tft_np)
    _, t_report = Trainer(tft, TrainerConfig(**tcfg), mesh=make_mesh(
        data=n, model=1, devices=["cpu"] * n)).train(
        xt, vt, params=params_from_numpy(tft_np, "cpu"))
    np.testing.assert_allclose(t_report["losses"], j_report["losses"],
                               rtol=1e-2)

    # GNN: node-sharded training (dropout draws its own randomness, so
    # only its finiteness is held) and risk scoring, held to JAX's
    from tests.test_torch_gnn import PORT, _graph, _pair
    from sitewhere_tpu_torch.training.maintenance import (
        MaintenanceTrainer,
        MaintenanceTrainerConfig,
    )

    jg, tg, gp, tgp = _pair(hidden=8)
    g = _graph(PORT)
    dp_mesh = make_mesh(data=n, model=1, devices=["cpu"] * n)
    trainer = MaintenanceTrainer(tg, MaintenanceTrainerConfig(
        steps=3, log_every=1), mesh=dp_mesh)
    want_risk = np.asarray(jg.risk(gp, jnp.asarray(g.node_feat),
                                   jnp.asarray(g.neighbors),
                                   jnp.asarray(g.nbr_mask)))[:g.n_devices]
    np.testing.assert_allclose(trainer.score(tgp, g), want_risk, atol=1e-5)
    g_params, g_report = trainer.train(g, params=tgp)
    assert np.isfinite(g_report["final_loss"])
    risk = trainer.score(g_params, g)
    assert risk.shape == (g.n_devices,) and np.isfinite(risk).all()
