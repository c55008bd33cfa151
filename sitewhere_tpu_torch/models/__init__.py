"""The port's model zoo. Every model follows one functional contract:

    init(generator) -> params
    score(params, x, valid) -> scores          # [B, W] -> [B]
    loss(params, x, valid) -> scalar           # self-supervised training

so the scoring session, the trainer and per-tenant stacking (`vmap`
over a leading tenant axis) treat every model identically. The GNN
scores a fleet graph instead (`risk`, `models/graph.py`).
"""

from sitewhere_tpu_torch.models.gnn import GnnConfig, GnnMaintenanceModel
from sitewhere_tpu_torch.models.graph import (
    FEATURE_DIM,
    FleetGraph,
    build_fleet_graph,
)
from sitewhere_tpu_torch.models.lstm import LstmAnomalyModel, LstmConfig
from sitewhere_tpu_torch.models.registry import MODEL_REGISTRY, build_model
from sitewhere_tpu_torch.models.tft import TftConfig, TftForecaster
from sitewhere_tpu_torch.models.zscore import ZScoreConfig, ZScoreModel

__all__ = [
    "LstmConfig", "LstmAnomalyModel",
    "TftConfig", "TftForecaster",
    "ZScoreConfig", "ZScoreModel",
    "GnnConfig", "GnnMaintenanceModel",
    "FleetGraph", "build_fleet_graph", "FEATURE_DIM",
    "MODEL_REGISTRY", "build_model",
]
