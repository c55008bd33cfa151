"""GNN predictive-maintenance model over the device-asset graph
(config 5 [BASELINE.json]).

The reference's device-asset graph exists implicitly as
`DeviceAssignment` rows linking devices to assets, areas, and customers
[SURVEY.md §2.1 object model]. This model makes that graph a compute
object: maintenance risk propagates between devices that share an asset
or an area (a failing pump stresses its siblings; a hot room degrades
every device in it).

- Static shapes throughout: nodes padded to a power of two, neighbor
  lists padded to a fixed fan-in `K` (`max_degree`) with a boolean mask
  (`models/graph.py`).
- GraphSAGE-style layers: `h' = relu(h·W_self + mean_k(h[nbr])·W_nbr)`.
  The neighbor aggregation is one row gather (`index_select`) + masked
  mean; matmuls round through the compute dtype, accumulation float32.
  Neighbor lists are 0-padded, so every gathered index is in range.
- Node-parallel sharding: `logits_blocks` runs the layers over node
  blocks, one a device (`MaintenanceTrainer(mesh=)` cuts them over the
  mesh's `data` axis); the neighbor gather sees every node, the blocks
  all-gathered onto each device once a layer, as the reference's XLA
  all-gather does.
- Supervision: past maintenance alerts (the event store is the label
  source — predictive maintenance learns from its own incident history).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils._pytree import tree_map

from sitewhere_tpu_torch.models.common import _matmul_round, dense_init
from sitewhere_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class GnnConfig:
    feature_dim: int = 10      # must match graph.FEATURE_DIM
    hidden: int = 64
    layers: int = 2
    max_degree: int = 16       # static neighbor fan-in K
    # column carrying the incident-history label-as-feature (graph.py's
    # "failed"); it is zeroed on the SELF path so a node's own label can
    # only reach its prediction through neighbor aggregation — otherwise
    # training collapses to the shortcut "failed→1" and risk never
    # propagates to unlabeled siblings. -1 disables the masking.
    label_feature_col: int = 9
    compute_dtype: Any = torch.bfloat16


class GnnMaintenanceModel:
    """Functional message-passing network on `device` (the card unless
    named): params are a tree; `risk` and `loss` take static shapes."""

    name = "gnn"

    def __init__(self, cfg: GnnConfig = GnnConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator | None = None) -> dict:
        cfg, dev = self.cfg, self.device
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        params: dict = {}
        d_in = cfg.feature_dim
        for layer in range(cfg.layers):
            params[f"self{layer}"] = dense_init(gen, d_in, cfg.hidden,
                                                device=dev)
            params[f"nbr{layer}"] = dense_init(gen, d_in, cfg.hidden,
                                               device=dev)
            d_in = cfg.hidden
        params["head"] = dense_init(gen, cfg.hidden, 1, device=dev)
        return params

    # -- forward -----------------------------------------------------------

    def _encode(self, params: dict, feats: list, neighbors: list,
                nbr_masks: list) -> list:
        """Message passing over node blocks in order (block i on its own
        device; neighbor ids index the whole graph) → embedding blocks
        [N_i, hidden]."""
        cfg = self.cfg
        cdt = cfg.compute_dtype
        ps = [tree_map(lambda t, d=f.device: t.to(d), params) for f in feats]
        hs = [f.float() for f in feats]
        h_selfs = [(h.index_fill(1, torch.tensor([cfg.label_feature_col],
                                                 device=h.device), 0.0)
                    if cfg.label_feature_col >= 0 else h) for h in hs]
        masks = [m.float()[..., None] for m in nbr_masks]     # [N, K, 1]
        denoms = [m.sum(1).clamp(min=1.0) for m in masks]     # [N, 1]
        flats = [n.reshape(-1).long() for n in neighbors]
        for layer in range(cfg.layers):
            # the neighbor gather sees every node: the blocks gathered
            # onto each device holding one
            whole: dict = {}
            for h in hs:
                if h.device not in whole:
                    whole[h.device] = hs[0] if len(hs) == 1 else torch.cat(
                        [x.to(h.device) for x in hs])
            out = []
            for i, h in enumerate(hs):
                n, k = neighbors[i].shape
                nbr_h = whole[h.device].index_select(0, flats[i]).reshape(
                    n, k, -1)                                 # [N, K, D]
                agg = (nbr_h * masks[i]).sum(1) / denoms[i]   # [N, D]
                ws = ps[i][f"self{layer}"]
                wn = ps[i][f"nbr{layer}"]
                z = (_matmul_round(h_selfs[i], ws["w"], cdt)
                     + _matmul_round(agg, wn["w"], cdt) + ws["b"] + wn["b"])
                out.append(torch.relu(z))
            hs = h_selfs = out
        return hs

    def logits_blocks(self, params: dict, feats: list, neighbors: list,
                      nbr_masks: list) -> list:
        """Per-node logits of each node block (see `_encode`)."""
        out = []
        for h in self._encode(params, feats, neighbors, nbr_masks):
            head = tree_map(lambda t, d=h.device: t.to(d), params["head"])
            out.append((h @ head["w"] + head["b"])[..., 0])
        return out

    def logits(self, params: dict, feat: torch.Tensor,
               neighbors: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
        return self.logits_blocks(params, [feat], [neighbors], [nbr_mask])[0]

    def risk(self, params: dict, feat: torch.Tensor, neighbors: torch.Tensor,
             nbr_mask: torch.Tensor) -> torch.Tensor:
        """Per-node maintenance risk in [0, 1]. feat: [N, F];
        neighbors/nbr_mask: [N, K] → [N] float32."""
        return torch.sigmoid(self.logits(params, feat, neighbors, nbr_mask))

    def loss(self, params: dict, feat: torch.Tensor, neighbors: torch.Tensor,
             nbr_mask: torch.Tensor, labels: torch.Tensor,
             label_mask: torch.Tensor) -> torch.Tensor:
        """Masked binary cross-entropy over labeled (device) nodes, with
        positive-class reweighting (failures are rare)."""
        return self.loss_from_logits(
            self.logits(params, feat, neighbors, nbr_mask), labels,
            label_mask)

    @staticmethod
    def loss_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                         label_mask: torch.Tensor) -> torch.Tensor:
        m = label_mask.float()
        y = labels.float()
        n_pos = (y * m).sum().clamp(min=1.0)
        n_neg = ((1.0 - y) * m).sum().clamp(min=1.0)
        w = torch.where(y > 0.5, n_neg / n_pos, torch.ones_like(y))
        ce = (logits.clamp(min=0) - logits * y
              + torch.log1p(torch.exp(-logits.abs())))
        return (ce * m * w).sum() / (m * w).sum().clamp(min=1.0)
