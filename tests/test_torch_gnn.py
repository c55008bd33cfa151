"""The port's fleet graph, GNN and maintenance trainer held against the
JAX package's on the same fleet, telemetry and weights.

- The graph (`build_fleet_graph`, `device_features`) is host numpy in
  both packages: exact.
- `risk`, `logits` and `loss` in float32 on both sides: atol 1e-5
  (risk), 1e-4 (logits, loss); their gradient 1e-4 plus 1e-3 relative.
  In bf16 (the default) the port rounds each product to bf16 as the
  reference casts: max |Δrisk| measured 6e-8 over eight seeds at these
  sizes; allowed 1e-5.
- `MaintenanceTrainer` with `feature_dropout=0` (the dropout masks come
  from each package's own generator) for five AdamW steps from the same
  params in float32: params within 1e-4 plus 1e-3 relative. The
  reference's training fixture sits on a knife edge (ROADMAP A.4 note),
  so the port's trainer is held to lowering the loss, not to its
  ordering outcome.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.domain.model import Area as JArea
from sitewhere_tpu.domain.model import Asset as JAsset
from sitewhere_tpu.domain.model import Device as JDevice
from sitewhere_tpu.domain.model import DeviceAssignment as JAssignment
from sitewhere_tpu.domain.model import DeviceType as JDeviceType
from sitewhere_tpu.models import graph as jgraph
from sitewhere_tpu.models.gnn import GnnConfig as JGnnConfig
from sitewhere_tpu.models.gnn import GnnMaintenanceModel as JGnn
from sitewhere_tpu.persistence.memory import InMemoryDeviceManagement as JDm
from sitewhere_tpu.persistence.telemetry import TelemetryStore as JStore
from sitewhere_tpu.sim.simulator import DeviceSimulator as JSim
from sitewhere_tpu.sim.simulator import SimConfig as JSimConfig
from sitewhere_tpu.training.maintenance import (
    MaintenanceTrainer as JTrainer,
    MaintenanceTrainerConfig as JTrainerConfig,
)
from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
from sitewhere_tpu_torch.domain.model import (
    Area,
    Asset,
    Device,
    DeviceAssignment,
    DeviceType,
)
from sitewhere_tpu_torch.models import graph as tgraph
from sitewhere_tpu_torch.models.gnn import GnnConfig, GnnMaintenanceModel
from sitewhere_tpu_torch.persistence.memory import InMemoryDeviceManagement
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from sitewhere_tpu_torch.training.maintenance import (
    MaintenanceTrainer,
    MaintenanceTrainerConfig,
    build_maintenance_model,
)

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = dict(dm=JDm, area=JArea, asset=JAsset, device=JDevice,
           assignment=JAssignment, device_type=JDeviceType, store=JStore,
           sim=JSim, sim_cfg=JSimConfig, graph=jgraph)
PORT = dict(dm=InMemoryDeviceManagement, area=Area, asset=Asset,
            device=Device, assignment=DeviceAssignment,
            device_type=DeviceType, store=TelemetryStore, sim=DeviceSimulator,
            sim_cfg=SimConfig, graph=tgraph)
K = 8


def _graph(pkg, n_devices=24, n_assets=4, n_areas=3, failed=(0, 4, 8),
           drift=0.3):
    """The bench's fleet shape (devices round-robin over assets, areas
    under one site), telemetry with drifting devices, some failures.
    Asset ids are fixed: the graph numbers asset nodes in id order."""
    dm = pkg["dm"]()
    dt = pkg["device_type"](token="pump", name="Pump")
    dm.create_device_type(dt)
    assets = [pkg["asset"](id=f"asset-{i}", token=f"asset-{i}", name=f"A{i}")
              for i in range(n_assets)]
    parent = pkg["area"](token="site", name="Site")
    areas = [parent] + [pkg["area"](token=f"area-{i}", name=f"Z{i}",
                                    parent_area_id=parent.id)
                        for i in range(n_areas)]
    for ar in areas:
        dm.create_area(ar)
    for i in range(n_devices):
        d = dm.create_device(pkg["device"](token=f"p-{i}",
                                           device_type_id=dt.id))
        dm.create_device_assignment(pkg["assignment"](
            device_id=d.id, token=f"p-{i}-a",
            asset_id=assets[i % n_assets].id,
            area_id=areas[1 + i % n_areas].id))
    store = pkg["store"](history=64)
    sim = pkg["sim"](pkg["sim_cfg"](num_devices=n_devices, seed=5,
                                    drift_fraction=drift,
                                    drift_per_hour=8.0),
                     tenant_id="t")
    for k in range(40):
        store.append_measurements(sim.tick(t=60.0 * k)[0])
    return pkg["graph"].build_fleet_graph(
        dm, store, window=32, max_degree=K,
        failed_device_indices=np.asarray(failed))


@pytest.mark.parametrize("failed", [(0, 4, 8), ()])
def test_fleet_graph_equals_jax(failed):
    got, want = _graph(PORT, failed=failed), _graph(JAX, failed=failed)
    for field in ("node_feat", "neighbors", "nbr_mask", "node_type",
                  "labels", "label_mask"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field), err_msg=field)
    assert (got.n_real, got.n_devices, got.n_edges, got.n_pad) == \
        (want.n_real, want.n_devices, want.n_edges, want.n_pad)
    assert got.n_pad % 8 == 0 and got.n_real == 24 + 4 + 4
    assert tgraph.FEATURE_NAMES == jgraph.FEATURE_NAMES


def _pair(dtype="float32", seed=3, hidden=16):
    jm = JGnn(JGnnConfig(feature_dim=jgraph.FEATURE_DIM, hidden=hidden,
                         layers=2, max_degree=K,
                         compute_dtype=getattr(jnp, dtype)))
    tm = GnnMaintenanceModel(GnnConfig(
        feature_dim=tgraph.FEATURE_DIM, hidden=hidden, layers=2,
        max_degree=K, compute_dtype=getattr(torch, dtype)), device="cpu")
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, tm, p, params_from_numpy(p, "cpu")


def _arrays(g):
    j = tuple(jnp.asarray(a) for a in (g.node_feat, g.neighbors, g.nbr_mask))
    t = tuple(torch.from_numpy(a) for a in (g.node_feat, g.neighbors,
                                            g.nbr_mask))
    return j, t


@pytest.mark.parametrize("surface,atol", [("risk", 1e-5), ("logits", 1e-4)])
def test_float32_forward_matches_jax(surface, atol):
    jm, tm, p, tp = _pair()
    g = _graph(PORT)
    ja, ta = _arrays(g)
    want = np.asarray(getattr(jm, surface)(p, *ja))
    got = getattr(tm, surface)(tp, *ta).numpy()
    assert got.shape == (g.n_pad,)
    np.testing.assert_allclose(got, want, atol=atol)


def test_bfloat16_risk_matches_jax():
    jm, tm, p, tp = _pair("bfloat16", seed=6)
    g = _graph(PORT)
    ja, ta = _arrays(g)
    np.testing.assert_allclose(tm.risk(tp, *ta).numpy(),
                               np.asarray(jm.risk(p, *ja)), atol=1e-5)


def test_loss_and_gradient_match_jax():
    jm, tm, p, tp = _pair()
    g = _graph(PORT)
    ja, ta = _arrays(g)
    labels = (jnp.asarray(g.labels), jnp.asarray(g.label_mask))
    tlabels = (torch.from_numpy(g.labels), torch.from_numpy(g.label_mask))
    want_loss, want = jax.value_and_grad(jm.loss)(p, *ja, *labels)
    leaves = {k: {n: v.requires_grad_(True) for n, v in d.items()}
              for k, d in tp.items()}
    loss = tm.loss(leaves, *ta, *tlabels)
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-4
    for k, d in leaves.items():
        for n, v in d.items():
            np.testing.assert_allclose(v.grad.numpy(), np.asarray(want[k][n]),
                                       atol=1e-4, rtol=1e-3,
                                       err_msg=f"{k}.{n}")


def test_maintenance_trainer_matches_jax_without_dropout():
    jm, tm, p, tp = _pair()
    g = _graph(PORT)
    cfg = dict(learning_rate=1e-2, steps=5, seed=0, log_every=1,
               feature_dropout=0.0, weight_decay=1e-3)
    jp, jreport = JTrainer(jm, JTrainerConfig(**cfg)).train(g, params=p)
    tp2, treport = MaintenanceTrainer(tm, MaintenanceTrainerConfig(
        **cfg)).train(g, params=tp)
    np.testing.assert_allclose(treport["losses"], jreport["losses"],
                               atol=1e-4)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-4, rtol=1e-3), params_to_numpy(tp2), jp)


def test_maintenance_trainer_lowers_the_loss_and_scores_devices():
    """Defaults (dropout 0.3, weight decay) from the port's own init: the
    loss falls, and `score` returns one risk in [0, 1] per device."""
    model = build_maintenance_model(hidden=16, layers=2, max_degree=K,
                                    device="cpu")
    g = _graph(PORT)
    trainer = MaintenanceTrainer(model, MaintenanceTrainerConfig(
        learning_rate=3e-2, steps=60, seed=1, log_every=10))
    params, report = trainer.train(g)
    assert report["losses"][-1] < report["losses"][0]
    risk = trainer.score(params, g)
    assert risk.shape == (g.n_devices,) and np.isfinite(risk).all()
    assert ((risk >= 0) & (risk <= 1)).all()
    # the labelled failures score above the fleet's median
    assert risk[[0, 4, 8]].mean() > np.median(risk)


def test_gnn_init_keeps_the_jax_layout():
    jm, tm, p, _ = _pair()
    mine = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(p)
    jax.tree.map(lambda a, b: (a.shape, a.dtype) == (b.shape, b.dtype)
                 or pytest.fail(f"{a.shape} vs {b.shape}"), mine, p)


def test_maintenance_trainer_over_a_mesh_matches_jax():
    """The node axis sharded over a 4-way `data` axis (logical CPU
    devices, the JAX trainer on 4 of its virtual devices): the steps
    match the JAX package's meshed trainer without dropout, and the
    port's meshless trainer with dropout (the masks are drawn whole on
    the first device)."""
    from sitewhere_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    jm, tm, p, tp = _pair()
    g = _graph(PORT)
    mesh = make_mesh(data=4, model=1, devices=["cpu"] * 4)
    cfg = dict(learning_rate=1e-2, steps=5, seed=0, log_every=1,
               feature_dropout=0.0, weight_decay=1e-3)
    jp, jreport = JTrainer(jm, JTrainerConfig(**cfg), mesh=jmake_mesh(
        data=4, model=1, devices=jax.devices()[:4])).train(g, params=p)
    tp2, treport = MaintenanceTrainer(tm, MaintenanceTrainerConfig(**cfg),
                                      mesh=mesh).train(g, params=tp)
    np.testing.assert_allclose(treport["losses"], jreport["losses"],
                               atol=1e-4)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-4, rtol=1e-3), params_to_numpy(tp2), jp)
    cfg["feature_dropout"] = 0.3
    meshed = MaintenanceTrainer(tm, MaintenanceTrainerConfig(**cfg),
                                mesh=mesh)
    mp, mreport = meshed.train(g, params=tp)
    _, report = MaintenanceTrainer(tm, MaintenanceTrainerConfig(
        **cfg)).train(g, params=tp)
    np.testing.assert_allclose(mreport["losses"], report["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(meshed.score(mp, g),
                               MaintenanceTrainer(tm).score(mp, g),
                               atol=1e-6)
    with pytest.raises(TypeError, match="Mesh"):
        MaintenanceTrainer(tm, mesh=object())
