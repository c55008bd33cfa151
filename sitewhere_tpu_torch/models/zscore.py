"""Rolling z-score detector: the training-free baseline rule.

score = |newest − mean(history)| / std. Works from the first window with
no training, so a fresh tenant gets anomaly detection immediately. Same
functional contract as every model (`init/score`); its params are empty.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sitewhere_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class ZScoreConfig:
    window: int = 64
    score_clip: float = 50.0
    min_history: int = 8


class ZScoreModel:
    name = "zscore"

    def __init__(self, cfg: ZScoreConfig = ZScoreConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    def init(self, gen: torch.Generator | None = None) -> dict:
        return {}  # stateless

    def score(self, params: dict, x: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
        v = valid.float()
        hist_v = v[:, :-1]
        n = hist_v.sum(-1).clamp(min=1.0)
        mu = (x[:, :-1] * hist_v).sum(-1) / n
        var = (((x[:, :-1] - mu[:, None]) * hist_v) ** 2).sum(-1) / n
        sd = torch.sqrt(var + 1e-6)
        score = (x[:, -1] - mu).abs() / sd
        enough = v.sum(-1) >= self.cfg.min_history
        return torch.where(enough, score, torch.zeros_like(score)).clamp(
            0.0, self.cfg.score_clip)

    def flops_per_event(self) -> float:
        """~8 elementwise FLOPs per window step (masked mean/var/score)."""
        return 8.0 * self.cfg.window
