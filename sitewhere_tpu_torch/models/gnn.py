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
- Node-parallel sharding over a mesh is ROADMAP A.2; one card holds the
  graph.
- Supervision: past maintenance alerts (the event store is the label
  source — predictive maintenance learns from its own incident history).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

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

    def _encode(self, params: dict, feat: torch.Tensor,
                neighbors: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
        """Message passing → node embeddings [N, hidden]."""
        cfg = self.cfg
        cdt = cfg.compute_dtype
        h = feat.float()
        # out of place: autograd keeps `h` for the neighbor path
        h_self = (h.index_fill(1, torch.tensor([cfg.label_feature_col],
                                               device=h.device), 0.0)
                  if cfg.label_feature_col >= 0 else h)
        mask = nbr_mask.float()[..., None]                    # [N, K, 1]
        denom = mask.sum(1).clamp(min=1.0)                    # [N, 1]
        n, k = neighbors.shape
        flat = neighbors.reshape(-1).long()
        for layer in range(cfg.layers):
            # `index_select`, not `h[neighbors]`: both gather the same
            # rows, but on the card the backward of advanced indexing
            # sorts its indices and adds repeated ones in series, and the
            # 0-padded lists repeat row 0 in most slots; `index_select`'s
            # backward is one `index_add_`
            nbr_h = h.index_select(0, flat).reshape(n, k, -1)  # [N, K, D]
            agg = (nbr_h * mask).sum(1) / denom               # [N, D]
            ws, wn = params[f"self{layer}"], params[f"nbr{layer}"]
            z = (_matmul_round(h_self, ws["w"], cdt)
                 + _matmul_round(agg, wn["w"], cdt) + ws["b"] + wn["b"])
            h = torch.relu(z)
            h_self = h
        return h

    def logits(self, params: dict, feat: torch.Tensor,
               neighbors: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
        h = self._encode(params, feat, neighbors, nbr_mask)
        head = params["head"]
        return (h @ head["w"] + head["b"])[..., 0]

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
        logits = self.logits(params, feat, neighbors, nbr_mask)
        m = label_mask.float()
        y = labels.float()
        n_pos = (y * m).sum().clamp(min=1.0)
        n_neg = ((1.0 - y) * m).sum().clamp(min=1.0)
        w = torch.where(y > 0.5, n_neg / n_pos, torch.ones_like(y))
        ce = (logits.clamp(min=0) - logits * y
              + torch.log1p(torch.exp(-logits.abs())))
        return (ce * m * w).sum() / (m * w).sum().clamp(min=1.0)
