"""Model registry: name → (config class, model class).

A tenant's rule-processing configuration selects a model by name.
"""

from __future__ import annotations

from typing import Any

from sitewhere_tpu_torch.models.lstm import LstmAnomalyModel, LstmConfig
from sitewhere_tpu_torch.models.zscore import ZScoreConfig, ZScoreModel

MODEL_REGISTRY: dict[str, tuple[type, type]] = {
    "lstm": (LstmConfig, LstmAnomalyModel),
    "zscore": (ZScoreConfig, ZScoreModel),
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
