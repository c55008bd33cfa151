"""The port's multi-process entry (`sitewhere_tpu_torch/parallel/
distributed.py`), as `tests/test_distributed.py` holds the JAX one: two
real OS processes join a `torch.distributed` group on gloo through the
SWX_* contract, build the global mesh (2 processes × 2 logical CPU
devices on the `data` axis), train data-parallel in lockstep, and reach
the losses of one process training over a 4-device mesh on the same
data (rtol 1e-5, the JAX test's). `cli train --distributed` runs the
same way. Without a coordinator `initialize_distributed` is a no-op
returning False.

Two ranks cannot share one card under nccl, so the lockstep pair is a
CPU test; on the card `chip_smoke.py` runs the CLI as one nccl process.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.parallel import distributed
from sitewhere_tpu_torch.parallel.mesh import make_mesh
from sitewhere_tpu_torch.training.trainer import Trainer, TrainerConfig

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r'''
import json, sys
sys.path.insert(0, "@REPO@")
import numpy as np, torch
torch.set_num_threads(1)
from sitewhere_tpu_torch.parallel.distributed import (
    initialize_distributed, make_global_mesh, process_info,
    shutdown_distributed)

assert initialize_distributed(device="cpu")   # SWX_* env contract
mesh = make_global_mesh(model=1, devices=["cpu", "cpu"])
info = process_info()
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.training.trainer import Trainer, TrainerConfig

model = build_model("lstm", device="cpu", window=16, hidden=8)
rng = np.random.default_rng(0)             # same data in every process
windows = rng.normal(10.0, 2.0, (256, 16)).astype(np.float32)
valid = np.ones_like(windows, dtype=bool)
trainer = Trainer(model, TrainerConfig(batch_size=64, steps=5, log_every=1),
                  mesh=mesh)
params, report = trainer.train(windows, valid)
shutdown_distributed()
print("RESULT " + json.dumps({"rank": info["process_index"],
                              "losses": report["losses"],
                              "data": mesh.shape["data"],
                              "backend": info["backend"]}))
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(argv_of, n=2, timeout=240):
    """Run `argv_of(rank)` for each rank with the SWX_* contract; returns
    each rank's stdout."""
    port = _free_port()
    procs = []
    for rank in range(n):
        env = dict(os.environ, SWX_COORDINATOR=f"127.0.0.1:{port}",
                   SWX_NUM_PROCESSES=str(n), SWX_PROCESS_ID=str(rank),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            argv_of(rank), cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-2000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _one_process_losses() -> list:
    model = build_model("lstm", device="cpu", window=16, hidden=8)
    rng = np.random.default_rng(0)
    windows = rng.normal(10.0, 2.0, (256, 16)).astype(np.float32)
    valid = np.ones_like(windows, dtype=bool)
    mesh = make_mesh(data=4, model=1, devices=["cpu"] * 4)
    _, report = Trainer(model, TrainerConfig(batch_size=64, steps=5,
                                             log_every=1),
                        mesh=mesh).train(windows, valid)
    return report["losses"]


def test_two_process_global_mesh_matches_single_process():
    worker = WORKER.replace("@REPO@", REPO)
    results = {}
    for out in _ranks(lambda rank: [sys.executable, "-c", worker]):
        for line in out.splitlines():
            if line.startswith("RESULT "):
                r = json.loads(line[len("RESULT "):])
                results[r["rank"]] = r
    assert set(results) == {0, 1}
    # lockstep: both processes computed the identical (global) losses
    assert results[0]["losses"] == results[1]["losses"]
    assert results[0]["data"] == 4 and results[0]["backend"] == "gloo"
    # one process over a 4-device mesh on the same data: the group
    # changes where the shards live, not the math
    np.testing.assert_allclose(results[0]["losses"], _one_process_losses(),
                               rtol=1e-5)


def test_cli_train_distributed_two_processes_in_lockstep(tmp_path):
    argv = [sys.executable, "-m", "sitewhere_tpu_torch.cli", "train",
            "--cpu", "--distributed", "--model", "lstm", "--window", "16",
            "--devices", "64", "--history", "48", "--batch-size", "64",
            "--steps", "4", "--checkpoint", str(tmp_path)]
    outs = _ranks(lambda rank: argv)
    reports = [json.loads([ln for ln in out.splitlines()
                           if ln.startswith("{")][0]) for out in outs]
    assert reports[0]["final_loss"] == reports[1]["final_loss"]
    assert reports[0]["steps"] == 4
    for rank, out in enumerate(outs):
        assert f"train: rank {rank}/2 backend=gloo data=2" in out
    # rank 0 alone writes the checkpoint
    assert sum("checkpoint:" in out for out in outs) == 1
    assert (tmp_path / "cli" / "lstm" / "v1").is_dir()


def test_no_coordinator_is_a_single_process_run(monkeypatch):
    monkeypatch.delenv("SWX_COORDINATOR", raising=False)
    assert distributed.initialize_distributed(device="cpu") is False
    info = distributed.process_info()
    assert info["initialized"] is False and info["process_count"] == 1
    mesh = distributed.make_global_mesh(model=1, devices=["cpu"] * 2)
    assert mesh.shape == {"data": 2, "model": 1}
    assert mesh.process_count == 1
