"""Fleet graph construction: device/asset/area tables → padded arrays.

Config 5's input [BASELINE.json]. The reference keeps the device-asset
graph relational — `DeviceAssignment` rows joining devices to assets and
areas behind `IDeviceManagement` [SURVEY.md §2.1 object model]; no code
upstream ever traverses it as a graph. Here it becomes the GNN's input:

  nodes  = devices (dense per-tenant index order) ⊕ assets ⊕ areas
  edges  = device—asset and device—area from ACTIVE assignments,
           plus area—parent-area from the area hierarchy (undirected)

Static shapes [SURVEY.md §7 hard part d]:
- node count padded to a power of two (and a multiple of
  `pad_multiple`), neighbor lists padded/truncated to static fan-in K —
  the model never sees a shape that changes with the fleet inside a
  capacity bucket;
- features are computed vectorized from the columnar telemetry store
  (one `window()` gather for the whole fleet — no per-device loop);
- device nodes come first and in dense-index order, so risk[i] maps back
  to device slot i with no index table on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.utils import grow_pow2

# feature layout (must match GnnConfig.feature_dim). `failed` carries the
# incident history INTO the graph: without it, devices with identical
# telemetry have identical receptive fields and risk cannot propagate
# from a failed device to its asset siblings (the transductive
# label-as-feature pattern; alerting still excludes already-failed
# devices, so there is no self-fulfilling alert loop).
FEATURE_NAMES = ("mean_n", "std_n", "last_z", "slope", "count_frac",
                 "degree", "is_device", "is_asset", "is_area", "failed")
FEATURE_DIM = len(FEATURE_NAMES)

NODE_DEVICE, NODE_ASSET, NODE_AREA = 0, 1, 2


@dataclass
class FleetGraph:
    """Static-shape graph arrays ready to move to the device."""

    node_feat: np.ndarray      # [N_pad, FEATURE_DIM] float32
    neighbors: np.ndarray      # [N_pad, K] int32 (0-padded where masked)
    nbr_mask: np.ndarray       # [N_pad, K] bool
    node_type: np.ndarray      # [N_pad] uint8 (NODE_* codes; 255 = pad)
    n_real: int                # real node count (<= N_pad)
    n_devices: int             # device nodes occupy [0, n_devices)
    n_edges: int               # undirected edge count before K-truncation
    labels: np.ndarray = field(default=None)      # [N_pad] float32
    label_mask: np.ndarray = field(default=None)  # [N_pad] bool

    @property
    def n_pad(self) -> int:
        return self.node_feat.shape[0]

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.node_feat, self.neighbors, self.nbr_mask



def _pad_to(n: int, multiple: int) -> int:
    """Next power of two ≥ n that is also a multiple of `multiple`
    (shared growth policy, utils/capacity.py)."""
    return grow_pow2(n, multiple=multiple)


def device_features(telemetry: TelemetryStore, n_devices: int,
                    window: int = 64, mtype: int = 0) -> np.ndarray:
    """Vectorized telemetry features per device: [D, 5] float32
    (normalized mean, std, last-z, slope, valid fraction)."""
    if n_devices == 0:
        return np.zeros((0, 5), np.float32)
    devices = np.arange(n_devices)
    x, valid = telemetry.window(devices, window, mtype=mtype)
    v = valid.astype(np.float32)
    n = np.maximum(v.sum(1), 1.0)
    mu = (x * v).sum(1) / n
    var = (((x - mu[:, None]) * v) ** 2).sum(1) / n
    sd = np.sqrt(var + 1e-6)
    last = x[:, -1]
    last_z = np.where(valid[:, -1], (last - mu) / sd, 0.0)
    # masked least-squares slope over the window (degradation trend —
    # the signal predictive maintenance cares about most)
    t = np.arange(window, dtype=np.float32)[None, :]
    t_mu = (t * v).sum(1) / n
    cov = ((t - t_mu[:, None]) * (x - mu[:, None]) * v).sum(1) / n
    t_var = (((t - t_mu[:, None]) * v) ** 2).sum(1) / n
    slope = cov / np.maximum(t_var, 1e-6)
    # scale-free: mean normalized by fleet stats, slope by per-device sd
    fleet_mu, fleet_sd = float(mu.mean()), float(mu.std() + 1e-6)
    feats = np.stack([
        (mu - fleet_mu) / fleet_sd,
        sd / np.maximum(fleet_sd, 1e-6),
        last_z,
        slope * window / sd,          # window-relative trend in sigmas
        v.sum(1) / window,
    ], axis=1).astype(np.float32)
    return np.clip(feats, -20.0, 20.0)


def build_fleet_graph(dm, telemetry: TelemetryStore, *, window: int = 64,
                      max_degree: int = 16, mtype: int = 0,
                      pad_multiple: int = 8,
                      failed_device_indices: Optional[np.ndarray] = None,
                      ) -> FleetGraph:
    """Build the padded fleet graph from a device-management engine/SPI.

    `dm` needs `list_devices`, `list_device_assignments`, `list_areas`
    (the `IDeviceManagement` query surface [SURVEY.md §2.1]).
    `failed_device_indices` (e.g. devices with maintenance alerts in the
    event store) become positive labels; all device nodes are labeled.
    """
    devices = dm.list_devices(page_size=1_000_000)
    n_devices = (max(d.index for d in devices) + 1) if devices else 0
    assignments = [a for a in dm.list_device_assignments(page_size=1_000_000)
                   if getattr(a.status, "value", a.status) == "active"]
    areas = dm.list_areas(page_size=1_000_000)

    # node numbering: devices (dense index) | assets | areas
    device_by_id = {d.id: d for d in devices}
    asset_ids = sorted({a.asset_id for a in assignments if a.asset_id})
    asset_node = {aid: n_devices + i for i, aid in enumerate(asset_ids)}
    area_node = {ar.id: n_devices + len(asset_ids) + i
                 for i, ar in enumerate(areas)}
    n_real = n_devices + len(asset_ids) + len(areas)
    n_pad = _pad_to(max(n_real, 1), pad_multiple)

    adj: list[list[int]] = [[] for _ in range(n_real)]
    n_edges = 0

    def add_edge(u: int, v: int) -> None:
        nonlocal n_edges
        adj[u].append(v)
        adj[v].append(u)
        n_edges += 1

    for a in assignments:
        dev = device_by_id.get(a.device_id)
        if dev is None or dev.index < 0:
            continue
        if a.asset_id and a.asset_id in asset_node:
            add_edge(dev.index, asset_node[a.asset_id])
        if a.area_id and a.area_id in area_node:
            add_edge(dev.index, area_node[a.area_id])
    for ar in areas:
        if ar.parent_area_id and ar.parent_area_id in area_node:
            add_edge(area_node[ar.id], area_node[ar.parent_area_id])

    neighbors = np.zeros((n_pad, max_degree), np.int32)
    nbr_mask = np.zeros((n_pad, max_degree), bool)
    for u in range(n_real):
        nbrs = adj[u][:max_degree]  # truncate over-degree nodes
        neighbors[u, :len(nbrs)] = nbrs
        nbr_mask[u, :len(nbrs)] = True

    node_type = np.full(n_pad, 255, np.uint8)
    node_type[:n_devices] = NODE_DEVICE
    node_type[n_devices:n_devices + len(asset_ids)] = NODE_ASSET
    node_type[n_devices + len(asset_ids):n_real] = NODE_AREA

    feat = np.zeros((n_pad, FEATURE_DIM), np.float32)
    feat[:n_devices, :5] = device_features(telemetry, n_devices, window, mtype)
    feat[:n_real, 5] = nbr_mask[:n_real].sum(1) / max_degree
    for code, col in ((NODE_DEVICE, 6), (NODE_ASSET, 7), (NODE_AREA, 8)):
        feat[:n_real, col] = (node_type[:n_real] == code)

    labels = np.zeros(n_pad, np.float32)
    label_mask = np.zeros(n_pad, bool)
    label_mask[:n_devices] = True
    if failed_device_indices is not None and len(failed_device_indices):
        idx = np.asarray(failed_device_indices, np.int64)
        idx = idx[idx < n_devices]
        labels[idx] = 1.0
        feat[idx, 9] = 1.0  # incident history as input (see FEATURE_NAMES)

    return FleetGraph(node_feat=feat, neighbors=neighbors, nbr_mask=nbr_mask,
                      node_type=node_type, n_real=n_real, n_devices=n_devices,
                      n_edges=n_edges, labels=labels, label_mask=label_mask)
