"""The port's training plane (`training/`: `Trainer`, `make_windows`,
`CheckpointStore`) and its CLI entries (`train`, `replay --candidate`)
held against the JAX package's.

- `make_windows` is host numpy in both packages: exact.
- `Trainer`: three Adam steps from the same params on the same batches
  (both draw `default_rng(seed).integers(0, n, bs)`), float32 compute:
  params within 1e-5 plus 1e-4 relative (max |Δ| measured 7.6e-7), the
  logged losses within 1e-5. The `lstm` loss and its gradient (the scan
  path, float32): 1e-5, and 1e-4 plus 1e-3 relative.
- Checkpoints: the npz layout with `keystr` keys; the port round-trips
  an `lstm` and a `tft` tree (lists included) exactly, the JAX
  `CheckpointStore.load` reads the port's `lstm` checkpoint exactly, and
  the port refuses an Orbax checkpoint by name (ROADMAP C).
- CLI: `train --cpu` writes a checkpoint the port loads; `replay --cpu
  --candidate` promotes the live params (exit 0), refuses perturbed ones
  (exit 1) and finds no checkpoint (exit 2).
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.models import build_model as jax_build
from sitewhere_tpu.training import checkpoint as jcheckpoint
from sitewhere_tpu.training.trainer import Trainer as JTrainer
from sitewhere_tpu.training.trainer import TrainerConfig as JTrainerConfig
from sitewhere_tpu.training.trainer import make_windows as jmake_windows
from sitewhere_tpu_torch import cli as tcli
from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.persistence import durable as tdurable
from sitewhere_tpu_torch.training.checkpoint import CheckpointStore
from sitewhere_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
    make_windows,
)

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)


def _series(seed=0, devices=24, history=48):
    rng = np.random.default_rng(seed)
    values = (rng.normal(20.0, 2.0, (devices, history))
              + np.sin(np.arange(history) / 3.0)).astype(np.float32)
    counts = rng.integers(history // 2, history + 1, devices)
    return values, counts


@pytest.mark.parametrize("stride,max_windows", [(1, None), (3, None),
                                                (1, 50)])
def test_make_windows_equals_jax(stride, max_windows):
    values, counts = _series()
    got = make_windows(values, counts, 16, stride=stride,
                       max_windows=max_windows, seed=4)
    want = jmake_windows(values, counts, 16, stride=stride,
                         max_windows=max_windows, seed=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


TRAIN = {
    "lstm": dict(window=16, hidden=8),
    "seasonal": dict(window=16, horizon=4),
}


def _train_pair(name):
    cfg = TRAIN[name]
    jcfg = ({**cfg, "compute_dtype": jnp.float32} if name == "lstm"
            else dict(cfg))
    tcfg = ({**cfg, "compute_dtype": torch.float32} if name == "lstm"
            else dict(cfg))
    jm = jax_build(name, **jcfg)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(2)))
    if name == "seasonal":
        p = {k: v + np.float32(0.05) for k, v in p.items()}
    return jm, build_model(name, device="cpu", **tcfg), p


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_loss_and_gradient_match_jax(layers):
    jm = jax_build("lstm", window=16, hidden=8, layers=layers,
                   compute_dtype=jnp.float32)
    tm = build_model("lstm", device="cpu", window=16, hidden=8,
                     layers=layers, compute_dtype=torch.float32)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(layers)))
    values, counts = _series(seed=2)
    x, valid = make_windows(values, counts, 16, max_windows=12)
    valid[0, :5] = False
    want_loss, want = jax.value_and_grad(jm.loss)(p, x, valid)
    tp = jax.tree.map(lambda t: t.requires_grad_(True),
                      params_from_numpy(p, "cpu"), is_leaf=torch.is_tensor)
    loss = tm.loss(tp, torch.from_numpy(x), torch.from_numpy(valid))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) < 1e-5
    jax.tree.map(lambda t, w: np.testing.assert_allclose(
        t.grad.numpy(), np.asarray(w), atol=1e-4, rtol=1e-3), tp, want,
        is_leaf=torch.is_tensor)


@pytest.mark.parametrize("name", list(TRAIN))
def test_trainer_steps_match_jax(name):
    jm, tm, p = _train_pair(name)
    values, counts = _series(seed=1)
    windows, valid = make_windows(values, counts, jm.cfg.window)
    cfg = dict(learning_rate=1e-2, batch_size=16, steps=3, seed=5,
               log_every=1)
    jp, jreport = JTrainer(jm, JTrainerConfig(**cfg)).train(
        windows, valid, params=p)
    tp, treport = Trainer(tm, TrainerConfig(**cfg)).train(
        windows, valid, params=params_from_numpy(p, "cpu"))
    np.testing.assert_allclose(treport["losses"], jreport["losses"],
                               atol=1e-5)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(
        a, np.asarray(b), atol=1e-5, rtol=1e-4), params_to_numpy(tp), jp)
    assert treport["steps"] == jreport["steps"] == 3


@pytest.mark.parametrize("name", ["lstm", "tft", "seasonal"])
def test_trainer_lowers_the_loss(name):
    """From the port's own init, default (bf16) compute."""
    cfg = {"lstm": dict(window=16, hidden=8),
           "tft": dict(window=16, horizon=4, hidden=8, heads=2,
                       min_history=4),
           "seasonal": dict(window=16, horizon=4)}[name]
    model = build_model(name, device="cpu", **cfg)
    rng = np.random.default_rng(3)
    t = np.arange(64)
    values = (20.0 + 3.0 * np.sin(t / 4.0)[None, :]
              + rng.normal(0.0, 0.3, (16, 64))).astype(np.float32)
    windows, valid = make_windows(values, np.full(16, 64), model.cfg.window)
    params, report = Trainer(model, TrainerConfig(
        learning_rate=1e-2, batch_size=32, steps=30, log_every=29)).train(
        windows, valid)
    assert report["losses"][-1] < report["losses"][0]
    assert all(not leaf.requires_grad for leaf in
               jax.tree.leaves(params, is_leaf=torch.is_tensor))


@pytest.mark.parametrize("name", list(TRAIN))
def test_trainer_over_a_mesh_matches_jax_and_meshless(name):
    """Data-parallel over a 2-way `data` axis (logical CPU devices): the
    batch is split, the replicas' gradients averaged into one step; the
    losses match the JAX trainer on 2 of its virtual devices and the
    port's meshless trainer on the same batches."""
    from sitewhere_tpu.parallel.mesh import make_mesh as jmake_mesh
    from sitewhere_tpu_torch.parallel.mesh import make_mesh

    jm, tm, p = _train_pair(name)
    values, counts = _series(seed=1)
    windows, valid = make_windows(values, counts, jm.cfg.window)
    cfg = dict(learning_rate=1e-2, batch_size=16, steps=3, seed=5,
               log_every=1)
    _, jreport = JTrainer(jm, JTrainerConfig(**cfg), mesh=jmake_mesh(
        data=2, model=1, devices=jax.devices()[:2])).train(
        windows, valid, params=p)
    mesh = make_mesh(data=2, model=1, devices=["cpu"] * 2)
    tp, treport = Trainer(tm, TrainerConfig(**cfg), mesh=mesh).train(
        windows, valid, params=params_from_numpy(p, "cpu"))
    _, plain = Trainer(tm, TrainerConfig(**cfg)).train(
        windows, valid, params=params_from_numpy(p, "cpu"))
    np.testing.assert_allclose(treport["losses"], jreport["losses"],
                               atol=1e-5)
    np.testing.assert_allclose(treport["losses"], plain["losses"],
                               atol=1e-5)
    assert all(not leaf.requires_grad for leaf in
               jax.tree.leaves(tp, is_leaf=torch.is_tensor))
    with pytest.raises(TypeError, match="Mesh"):
        Trainer(tm, mesh=object())


# -- checkpoints ---------------------------------------------------------------

@pytest.mark.parametrize("name,cfg", [
    ("lstm", dict(window=16, hidden=8, layers=2)),
    ("tft", dict(window=16, horizon=4, hidden=8, heads=2))])
def test_checkpoint_round_trips_exactly(tmp_path, name, cfg):
    model = build_model(name, device="cpu", **cfg)
    params = model.init(torch.Generator().manual_seed(3))
    store = CheckpointStore(str(tmp_path))
    assert store.save("t", name, params, metadata={"window": 16}) == 1
    assert store.save("t", name, params) == 2
    assert store.versions("t", name) == [1, 2]
    back, meta = store.load("t", name, version=1)
    assert meta["version"] == 1 and meta["window"] == 16
    want = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    jax.tree.map(np.testing.assert_array_equal, back, want)
    store.prune("t", name, keep=1)
    assert store.versions("t", name) == [2]
    with pytest.raises(FileNotFoundError):
        store.load("t", "zscore")


def test_jax_loads_the_port_lstm_checkpoint(tmp_path):
    model = build_model("lstm", device="cpu", window=16, hidden=8)
    params = model.init(torch.Generator().manual_seed(4))
    CheckpointStore(str(tmp_path)).save("cli", "lstm", params)
    back, meta = jcheckpoint.CheckpointStore(str(tmp_path)).load("cli", "lstm")
    assert meta["version"] == 1
    jax.tree.map(np.testing.assert_array_equal, back,
                 params_to_numpy(params))
    # and the JAX model scores with them
    jm = jax_build("lstm", window=16, hidden=8)
    x = np.full((2, 16), 20.0, np.float32)
    assert np.isfinite(np.asarray(jm.score(back, x, np.ones_like(x, bool)))).all()


def test_port_refuses_a_jax_orbax_checkpoint(tmp_path):
    if jcheckpoint.ocp is None:
        pytest.skip("orbax is not installed: the JAX package writes npz")
    jm = jax_build("lstm", window=16, hidden=8)
    jcheckpoint.CheckpointStore(str(tmp_path)).save(
        "t", "lstm", jm.init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match="Orbax"):
        CheckpointStore(str(tmp_path)).load("t", "lstm")


# -- the CLI -------------------------------------------------------------------

def _cli(argv) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = tcli.main(argv)
    return rc, out.getvalue()


def test_cli_train_writes_a_checkpoint(tmp_path):
    rc, out = _cli(["train", "--cpu", "--model", "lstm-stream", "--window",
                    "16", "--devices", "32", "--history", "40",
                    "--batch-size", "32", "--steps", "3", "--checkpoint",
                    str(tmp_path)])
    assert rc == 0
    lines = out.strip().splitlines()
    report = json.loads(lines[0])
    assert report["steps"] == 3 and np.isfinite(report["final_loss"])
    assert lines[1] == f"checkpoint: {tmp_path}/cli/lstm-stream/v1"
    params, meta = CheckpointStore(str(tmp_path)).load("cli", "lstm-stream")
    assert meta["window"] == 16 and params["lstm0"]["wx"].shape == (1, 256)


def test_cli_train_distributed_needs_a_coordinator(monkeypatch, capsys):
    """`--distributed` with no coordinator (flag or SWX_COORDINATOR)
    exits 2, as the JAX CLI does; the group itself is held in
    tests/test_torch_distributed.py."""
    monkeypatch.delenv("SWX_COORDINATOR", raising=False)
    assert tcli.main(["train", "--cpu", "--distributed", "--steps",
                      "1"]) == 2
    assert "no coordinator" in capsys.readouterr().err


DEVICES, W = 64, 16


def _data_dir(root):
    """A stopped instance's `data_dir` for tenant acme: a durable log of
    16 events a device."""
    rng = np.random.default_rng(2)
    log = tdurable.SegmentLog(str(root / "tenants" / "acme" / "events"))
    for i in range(16):
        val = rng.normal(20.0, 1.0, DEVICES).astype(np.float32)
        log.append(tdurable.RT_MEASUREMENTS, tbatch.MeasurementBatch(
            tbatch.BatchContext("acme"),
            np.arange(DEVICES, dtype=np.uint32),
            np.zeros(DEVICES, np.uint16), val,
            np.full(DEVICES, 1_700_000_000.0 + 10.0 * i)).encode())
    log.close()
    return str(root)


def test_cli_replay_candidate_gate(tmp_path):
    """The candidate checkpoint (the tenant's, else `cli`'s): the live
    params themselves are promoted (max |Δ| 0), a perturbed copy is
    refused with its divergence report, and an empty root has none."""
    data_dir = _data_dir(tmp_path / "data")
    model = build_model("lstm-stream", device="cpu", window=W)
    live = model.init(torch.Generator().manual_seed(0))  # the pool's seed
    ckpt = tmp_path / "ckpt"
    store = CheckpointStore(str(ckpt))
    store.save("cli", "lstm-stream", live)
    store.save("cli", "lstm-stream",
               jax.tree.map(lambda t: t + 0.5, live, is_leaf=torch.is_tensor))
    base = ["replay", "--cpu", "--data-dir", data_dir, "--tenant", "acme",
            "--model", "lstm-stream", "--window", str(W), "--candidate",
            str(ckpt), "--max-divergence", "0.05"]
    rc, out = _cli(base + ["--candidate-version", "1"])
    report = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and report["promoted"] and report["max_abs"] == 0.0
    assert report["events"] == 16 * DEVICES
    rc, out = _cli(base + ["--candidate-version", "2"])
    report = json.loads(out.strip().splitlines()[-1])
    assert rc == 1 and not report["promoted"] and report["max_abs"] > 0.05
    rc, _ = _cli(base[:-3] + [str(tmp_path / "empty"), "--max-divergence",
                              "0.05"])
    assert rc == 2
