"""Model registry: name → (config class, model class).

A tenant's rule-processing configuration selects a model by name.
"""

from __future__ import annotations

from typing import Any

from sitewhere_tpu_torch.models.longwin import LongWindowConfig, LongWindowModel
from sitewhere_tpu_torch.models.lstm import (
    LstmAnomalyModel,
    LstmConfig,
    StreamingLstmModel,
)
from sitewhere_tpu_torch.models.seasonal import (
    SeasonalTrendConfig,
    SeasonalTrendForecaster,
)
from sitewhere_tpu_torch.models.tft import TftConfig, TftForecaster
from sitewhere_tpu_torch.models.zscore import ZScoreConfig, ZScoreModel

MODEL_REGISTRY: dict[str, tuple[type, type]] = {
    "lstm": (LstmConfig, LstmAnomalyModel),
    "lstm-stream": (LstmConfig, StreamingLstmModel),
    "tft": (TftConfig, TftForecaster),
    "zscore": (ZScoreConfig, ZScoreModel),
    "longwin": (LongWindowConfig, LongWindowModel),
    # the fleet's own load forecaster
    "seasonal": (SeasonalTrendConfig, SeasonalTrendForecaster),
}


def build_model(name: str, device=None, **cfg_overrides: Any):
    """Instantiate a model by registry name with config overrides, on
    `device` (the card unless named)."""
    try:
        cfg_cls, model_cls = MODEL_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown model {name!r} (known: {sorted(MODEL_REGISTRY)})") from None
    return model_cls(cfg_cls(**cfg_overrides), device=device)
