"""Self-supervised trainer over windows cut from the telemetry store.

The training plane of the JAX package's `training/trainer.py`, on one
card: the dataset is sliding windows cut from a `TelemetryStore`
snapshot (`[D, T]` → `[N, W]` via one strided gather), each step draws
a batch with `np.random.default_rng(seed).integers(0, n, bs)` — the
reference's draw, so both trainers see the same batches — and takes one
`torch.optim.Adam` step on `model.loss` (optax's `adam`: the same lr,
betas (0.9, 0.999) and eps 1e-8).

Data-parallel over a mesh (`parallel/mesh.py`): the batch — a multiple
of the `data` axis — is split over the `data` axis's devices, each shard
computes the loss of its rows with its own replica of the params (a
copy on its device that autograd traces back to the one set of params),
and the replicas' gradients are averaged into those params before one
optimizer step. Over a process group (`parallel/distributed.py`) each
process computes its own shards and the gradients and the loss are
all-reduced over the group, so every process takes the same step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from sitewhere_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    model_index,
    place,
    place_tree,
    replicated,
    shard_batch,
)


@dataclass(frozen=True)
class TrainerConfig:
    learning_rate: float = 1e-3
    batch_size: int = 1024
    steps: int = 200
    seed: int = 0
    log_every: int = 50


def make_windows(values: np.ndarray, counts: np.ndarray, window: int,
                 stride: int = 1, max_windows: Optional[int] = None,
                 seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Cut training windows from a store snapshot.

    values: [D, T] chronological per device; counts: [D] valid suffix
    lengths (ring semantics: the valid data is the LAST `counts[d]`
    entries). Returns (windows [N, W], valid [N, W]).
    """
    d_count, t = values.shape
    # per-device window count, then flat (device, start) arrays — all
    # vectorized (a per-device loop takes minutes at fleet scale)
    c = np.minimum(counts.astype(np.int64), t)
    nw = np.where(c >= window, (c - window) // stride + 1, 0)
    total = int(nw.sum())
    if total == 0:
        return (np.zeros((0, window), np.float32),
                np.zeros((0, window), bool))
    dev = np.repeat(np.arange(d_count), nw)
    cum = np.concatenate([[0], np.cumsum(nw)[:-1]])
    ordinal = np.arange(total) - np.repeat(cum, nw)
    start = (t - c)[dev] + ordinal * stride
    if max_windows is not None and total > max_windows:
        rng = np.random.default_rng(seed)
        pick = rng.choice(total, max_windows, replace=False)
        dev, start = dev[pick], start[pick]
    # one strided view + one row gather: indices stay [N], not [N, W]
    sw = np.lib.stride_tricks.sliding_window_view(values, window, axis=1)
    windows = sw[dev, start]
    return windows.astype(np.float32, copy=False), \
        np.ones_like(windows, dtype=bool)


def trainable(params, device):
    """A copy of `params` on `device` as float32 leaves that require
    grad (the optimizer updates these in place)."""
    return tree_map(lambda v: v.detach().to(device, torch.float32).clone()
                    .requires_grad_(True), params)


def data_parallel_loss(loss_fn, params, mesh: Mesh, *batch) -> torch.Tensor:
    """This process's share of the mean data-parallel loss: params
    replicated, this process's rows of the global batch sharded over its
    `data` devices, and the sum of `loss_fn` over its shards divided by
    the global data size."""
    per = batch[0].shape[0] // mesh.process_count
    rows = slice(mesh.process_index * per, (mesh.process_index + 1) * per)
    replicas = place_tree(params, lambda t: place(t, replicated(mesh)), mesh)
    *shards, _ = shard_batch(mesh, *(b[rows] for b in batch))
    total = sum(loss_fn(replicas[pos], *(s.blocks[pos] for s in shards))
                .to(mesh.first) for pos in mesh.positions()
                if model_index(mesh, pos) == 0)
    return total / mesh.shape[DATA_AXIS]


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Sum the gradients over the mesh's process group (no-op for one
    process)."""
    if mesh.process_count == 1:
        return
    import torch.distributed as dist

    for leaf in tree_leaves(params):
        if leaf.grad is not None:
            dist.all_reduce(leaf.grad)


def reduced_loss(loss: torch.Tensor, mesh: Mesh) -> float:
    """The loss summed over the mesh's process group."""
    loss = loss.detach().clone()
    if mesh.process_count > 1:
        import torch.distributed as dist

        dist.all_reduce(loss)
    return float(loss)


class Trainer:
    """Self-supervised trainer for any registry model, on the model's
    device, or data-parallel over `mesh`."""

    def __init__(self, model, cfg: TrainerConfig = TrainerConfig(),
                 mesh: Optional[Mesh] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.model = model
        self.cfg = cfg
        self.mesh = mesh

    def train(self, windows: np.ndarray, valid: np.ndarray,
              params: Optional[dict] = None) -> tuple[dict, dict]:
        """Train over the window dataset; returns (params, report)."""
        cfg, model, mesh = self.cfg, self.model, self.mesh
        device = model.device if mesh is None else mesh.first
        if params is None:
            params = model.init(torch.Generator().manual_seed(cfg.seed))
        params = trainable(params, device)
        n = windows.shape[0]
        if n == 0:
            return tree_map(torch.Tensor.detach, params), {
                "steps": 0, "losses": [], "seconds": 0.0}
        opt = torch.optim.Adam(tree_leaves(params), lr=cfg.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        bs = cfg.batch_size
        if mesh is not None:
            d = mesh.shape[DATA_AXIS]
            bs = max((bs // d) * d, d)  # divisible by the data axis
        rng = np.random.default_rng(cfg.seed)
        losses = []
        t0 = time.monotonic()
        for step_i in range(cfg.steps):
            idx = rng.integers(0, n, bs)
            xb = torch.from_numpy(np.ascontiguousarray(windows[idx]))
            vb = torch.from_numpy(np.ascontiguousarray(valid[idx]))
            opt.zero_grad(set_to_none=True)
            if mesh is None:
                loss = model.loss(params, xb.to(device), vb.to(device))
                loss.backward()
            else:
                loss = data_parallel_loss(model.loss, params, mesh, xb, vb)
                loss.backward()
                all_reduce_grads(params, mesh)
            opt.step()
            if step_i % cfg.log_every == 0 or step_i == cfg.steps - 1:
                losses.append(float(loss.detach()) if mesh is None
                              else reduced_loss(loss, mesh))
        elapsed = time.monotonic() - t0
        return tree_map(torch.Tensor.detach, params), {
            "steps": cfg.steps, "losses": losses, "seconds": elapsed,
            "final_loss": losses[-1] if losses else None}
