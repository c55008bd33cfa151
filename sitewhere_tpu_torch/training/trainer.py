"""Self-supervised trainer over windows cut from the telemetry store.

The training plane of the JAX package's `training/trainer.py`, on one
card: the dataset is sliding windows cut from a `TelemetryStore`
snapshot (`[D, T]` → `[N, W]` via one strided gather), each step draws
a batch with `np.random.default_rng(seed).integers(0, n, bs)` — the
reference's draw, so both trainers see the same batches — and takes one
`torch.optim.Adam` step on `model.loss` (optax's `adam`: the same lr,
betas (0.9, 0.999) and eps 1e-8). Data-parallel training over a mesh is
ROADMAP A.2: a `mesh` raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from sitewhere_tpu_torch.utils.roadmap import not_ported


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


class Trainer:
    """Self-supervised trainer for any registry model, on the model's
    device."""

    def __init__(self, model, cfg: TrainerConfig = TrainerConfig(),
                 mesh=None):
        if mesh is not None:
            raise not_ported("data-parallel training over a mesh", "A.2")
        self.model = model
        self.cfg = cfg

    def train(self, windows: np.ndarray, valid: np.ndarray,
              params: Optional[dict] = None) -> tuple[dict, dict]:
        """Train over the window dataset; returns (params, report)."""
        cfg, model = self.cfg, self.model
        device = model.device
        if params is None:
            params = model.init(torch.Generator().manual_seed(cfg.seed))
        params = trainable(params, device)
        n = windows.shape[0]
        if n == 0:
            return tree_map(torch.Tensor.detach, params), {
                "steps": 0, "losses": [], "seconds": 0.0}
        opt = torch.optim.Adam(tree_leaves(params), lr=cfg.learning_rate,
                               betas=(0.9, 0.999), eps=1e-8)
        rng = np.random.default_rng(cfg.seed)
        losses = []
        t0 = time.monotonic()
        for step_i in range(cfg.steps):
            idx = rng.integers(0, n, cfg.batch_size)
            xb = torch.from_numpy(np.ascontiguousarray(windows[idx])).to(device)
            vb = torch.from_numpy(np.ascontiguousarray(valid[idx])).to(device)
            opt.zero_grad(set_to_none=True)
            loss = model.loss(params, xb, vb)
            loss.backward()
            opt.step()
            if step_i % cfg.log_every == 0 or step_i == cfg.steps - 1:
                losses.append(float(loss.detach()))
        elapsed = time.monotonic() - t0
        return tree_map(torch.Tensor.detach, params), {
            "steps": cfg.steps, "losses": losses, "seconds": elapsed,
            "final_loss": losses[-1] if losses else None}
