"""Predictive-maintenance training + fleet scoring (config 5).

Full-graph training of the GNN on the device-asset graph, supervised by
incident history (devices with maintenance alerts in the event store —
the durable source of truth the reference also resumes from
[SURVEY.md §5.4]). The graph's arrays stay on the card for the whole
run; `torch.optim.AdamW` stands in for optax's `adamw` (both decay the
weights decoupled from the gradient, by lr · weight_decay a step).

Over a mesh (`mesh=`) the node axis is sharded over the `data` axis's
devices (the graph's node count padded to a multiple of it): each
device runs the layers on its node block, the neighbor gather sees every
node (`GnnMaintenanceModel.logits_blocks`), and the loss is taken over
the whole graph on the first device, so a step is the meshless step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from sitewhere_tpu_torch.models.gnn import GnnConfig, GnnMaintenanceModel
from sitewhere_tpu_torch.models.graph import FleetGraph
from sitewhere_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, split_blocks
from sitewhere_tpu_torch.training.trainer import trainable


@dataclass(frozen=True)
class MaintenanceTrainerConfig:
    learning_rate: float = 1e-2
    steps: int = 200
    seed: int = 0
    log_every: int = 50
    # regularization against per-device fingerprinting: with few labeled
    # failures the net can memorize which telemetry fingerprints were
    # labeled instead of learning shared signals (neighborhood incident
    # rate, degradation trend). Input-feature dropout + weight decay
    # force generalization.
    feature_dropout: float = 0.3
    weight_decay: float = 1e-3


class MaintenanceTrainer:
    """Full-graph GNN trainer: the graph's arrays resident on the
    model's device (or their node blocks on the mesh's `data` devices)
    for the whole run."""

    def __init__(self, model: GnnMaintenanceModel,
                 cfg: MaintenanceTrainerConfig = MaintenanceTrainerConfig(),
                 mesh: Optional[Mesh] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.mesh.Mesh, not "
                            f"{type(mesh).__name__}")
        self.model = model
        self.cfg = cfg
        self.mesh = mesh

    @property
    def _devices(self) -> list:
        """The node blocks' devices (one: the model's, meshless)."""
        if self.mesh is None:
            return [self.model.device]
        return self.mesh.axis_devices(DATA_AXIS)

    def _place(self, graph: FleetGraph):
        """The graph's arrays on the first device."""
        dev = self._devices[0]
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (graph.node_feat, graph.neighbors,
                               graph.nbr_mask, graph.labels,
                               graph.label_mask))

    def _logits(self, params, feat, nbrs, mask) -> torch.Tensor:
        """Whole-graph logits on the first device, from node blocks."""
        devs = self._devices
        if len(devs) == 1:
            return self.model.logits(params, feat, nbrs, mask)
        blocks = self.model.logits_blocks(
            params, split_blocks(feat, devs, 0), split_blocks(nbrs, devs, 0),
            split_blocks(mask, devs, 0))
        return torch.cat([b.to(devs[0]) for b in blocks])

    def train(self, graph: FleetGraph,
              params: Optional[dict] = None) -> tuple[dict, dict]:
        model, cfg = self.model, self.cfg
        dev = self._devices[0]
        if params is None:
            params = model.init(torch.Generator().manual_seed(cfg.seed))
        params = trainable(params, dev)
        feat, nbrs, mask, labels, label_mask = self._place(graph)
        opt = torch.optim.AdamW(tree_leaves(params), lr=cfg.learning_rate,
                                betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=cfg.weight_decay)
        p_drop = cfg.feature_dropout
        # the dropout masks' stream: explicit and seeded, on the device
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        losses = []
        t0 = time.monotonic()
        for i in range(cfg.steps):
            f = feat
            if p_drop > 0.0:
                keep = torch.rand(feat.shape, generator=gen,
                                  device=dev) < 1.0 - p_drop
                f = torch.where(keep, feat / (1.0 - p_drop),
                                torch.zeros_like(feat))
            opt.zero_grad(set_to_none=True)
            loss = model.loss_from_logits(
                self._logits(params, f, nbrs, mask), labels, label_mask)
            loss.backward()
            opt.step()
            if i % cfg.log_every == 0 or i == cfg.steps - 1:
                losses.append(float(loss.detach()))
        return tree_map(torch.Tensor.detach, params), {
            "steps": cfg.steps, "losses": losses,
            "final_loss": losses[-1] if losses else None,
            "seconds": round(time.monotonic() - t0, 3)}

    def score(self, params: dict, graph: FleetGraph) -> np.ndarray:
        """Per-device maintenance risk [n_devices] float32 in [0, 1]."""
        feat, nbrs, mask, _, _ = self._place(graph)
        with torch.no_grad():
            risk = torch.sigmoid(self._logits(params, feat, nbrs, mask))
        return risk.cpu().numpy()[: graph.n_devices]


def build_maintenance_model(hidden: int = 32, layers: int = 2,
                            max_degree: int = 16,
                            device=None) -> GnnMaintenanceModel:
    from sitewhere_tpu_torch.models.graph import FEATURE_DIM

    return GnnMaintenanceModel(GnnConfig(
        feature_dim=FEATURE_DIM, hidden=hidden, layers=layers,
        max_degree=max_degree), device=device)
