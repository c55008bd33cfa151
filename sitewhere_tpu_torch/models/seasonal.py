"""Seasonal-trend linear forecaster: the fleet's own load model.

The predictive control plane needs a forecaster that (a) extrapolates a
load RAMP from a short context even when freshly initialized, and (b)
rides the shared megabatch pool unmodified, i.e. speaks the exact
registry-model protocol every detector speaks (`init`,
`score/loss(params, x[B, W], valid[B, W])`, static shapes, no Python
branching on data).

Structure (Holt-style level+trend with a learned residual head):

- **structural half, parameter-free**: masked discounted least-squares
  level and slope over the context region of the normalized window; the
  base forecast is `level + slope · h` — a zero-initialized model
  already extrapolates trends correctly.
- **learned half**: a linear read of the detrended context residuals
  (`w · r`, one weight per context step) plus `harmonics` sin/cos
  seasonal terms over window position, a trend gain and a bias —
  trained by the ordinary `training/trainer.py` loop on history windows
  (Huber over the horizon tail, masked by validity).

`score` returns the predicted load at the horizon in ORIGINAL units
(max over horizon steps, floored at 0), so the pool's per-tenant
threshold doubles as a scale-up bar and a `ScoredBatch`'s scores ARE the
per-tenant forecasts. Everything is float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from sitewhere_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class SeasonalTrendConfig:
    window: int = 32           # total input length W (context + horizon)
    horizon: int = 6           # forecast steps H
    harmonics: int = 2         # seasonal sin/cos pairs over window position
    min_history: int = 4       # valid context steps needed to forecast
    score_clip: float = 1e9

    @property
    def context(self) -> int:
        return self.window - self.horizon


class SeasonalTrendForecaster:
    """Functional model on `device` (the card unless named); params are
    an explicit tree (the TenantStack stacks these leaves per tenant slot
    exactly like the detectors')."""

    name = "seasonal"

    def __init__(self, cfg: SeasonalTrendConfig = SeasonalTrendConfig(),
                 device=None):
        if cfg.horizon >= cfg.window:
            raise ValueError("horizon must be < window")
        if cfg.horizon < 1:
            raise ValueError("horizon must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- params --------------------------------------------------------------

    def init(self, gen: torch.Generator | None = None) -> dict:
        # zero init IS the model: the structural half already forecasts;
        # training only learns corrections
        cfg, dev = self.cfg, self.device
        return {
            "w": torch.zeros(cfg.context, dtype=torch.float32, device=dev),
            "season": torch.zeros(2 * cfg.harmonics, dtype=torch.float32,
                                  device=dev),
            "gain": torch.ones((), dtype=torch.float32, device=dev),
            "bias": torch.zeros((), dtype=torch.float32, device=dev),
        }

    # -- structural pieces ---------------------------------------------------

    def _normalize(self, x, valid):
        """Masked mean/std over the CONTEXT region only (the horizon
        tail is the training target; its stats must not leak)."""
        cfg = self.cfg
        v = valid[:, :cfg.context].float()
        xc = x[:, :cfg.context]
        n = v.sum(-1, keepdim=True).clamp(min=1.0)
        mu = (xc * v).sum(-1, keepdim=True) / n
        var = (((xc - mu) * v) ** 2).sum(-1, keepdim=True) / n
        sd = torch.sqrt(var + 1e-6)
        return (x - mu) / sd, mu, sd

    def _level_slope(self, xn, valid):
        """Masked DISCOUNTED least-squares level (value at the last
        context step) and per-step slope over the valid context points,
        newest step weight 1, older ones decaying by γ per step — an
        unweighted fit over the whole context dilutes a ramp onset.
        < 2 effective points pins the slope to 0 (level-only)."""
        cfg = self.cfg
        c = cfg.context
        dev = xn.device
        gamma = 0.85
        decay = gamma ** torch.arange(c - 1, -1, -1, dtype=torch.float32,
                                      device=dev)
        v = valid[:, :c].float() * decay[None, :]
        xc = xn[:, :c]
        t = torch.arange(c, dtype=torch.float32, device=dev)[None, :]
        n = v.sum(-1).clamp(min=1.0)
        tm = (t * v).sum(-1) / n
        xm = (xc * v).sum(-1) / n
        dt = (t - tm[:, None]) * v
        cov = (dt * (xc - xm[:, None])).sum(-1) / n
        var = (dt * dt).sum(-1) / n
        zero = torch.zeros_like(cov)
        slope = torch.where(var > 1e-9, cov / var.clamp(min=1e-9), zero)
        slope = torch.where(v.sum(-1) >= 2.0, slope, zero)
        level = xm + slope * (c - 1.0 - tm)
        return level, slope, v

    def _predict_norm(self, params, xn, valid):
        """Forecast of the horizon steps in NORMALIZED units: [B, H]."""
        cfg = self.cfg
        c, h = cfg.context, cfg.horizon
        dev = xn.device
        level, slope, v = self._level_slope(xn, valid)
        steps = torch.arange(1, h + 1, dtype=torch.float32, device=dev)[None, :]
        base = level[:, None] + slope[:, None] * steps          # [B, H]
        # learned residual read over the detrended context
        t = torch.arange(c, dtype=torch.float32, device=dev)[None, :]
        fit = level[:, None] + slope[:, None] * (t - (c - 1.0))
        resid = (xn[:, :c] - fit) * v                           # [B, C]
        corr = resid @ params["w"]                              # [B]
        # seasonal harmonics over absolute window position
        pos = (c - 1.0 + steps) / cfg.window                    # [1, H]
        ks = torch.arange(1, cfg.harmonics + 1, dtype=torch.float32,
                          device=dev)
        ang = 2.0 * math.pi * ks[:, None] * pos                 # [K, H]
        seas = (params["season"][:cfg.harmonics] @ torch.sin(ang)
                + params["season"][cfg.harmonics:] @ torch.cos(ang))  # [H]
        return (params["gain"] * base + params["bias"]
                + corr[:, None] + seas[None, :])

    # -- public API ----------------------------------------------------------

    def forecast(self, params: dict, x: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        """Horizon forecast in ORIGINAL units: [B, H]."""
        xn, mu, sd = self._normalize(x, valid)
        return self._predict_norm(params, xn, valid) * sd + mu

    def score(self, params: dict, x: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
        """Predicted load at the horizon BEYOND the newest observed
        step, original units: the max over horizon steps, floored at 0.
        The serving ring hands the LAST W observed points (newest at
        W-1), so the window is shifted to put the newest `context` steps
        in the context region and the horizon extrapolates past the end
        of the data. Windows with fewer than `min_history` valid context
        steps score 0 ("no forecast"). x: [B, W], valid: [B, W] → [B]."""
        cfg = self.cfg
        h = cfg.horizon
        xs = torch.cat([x[:, h:], torch.zeros_like(x[:, :h])], dim=-1)
        vs = torch.cat([valid[:, h:], torch.zeros_like(valid[:, :h])], dim=-1)
        pred = self.forecast(params, xs, vs).amax(-1)
        enough = vs[:, :cfg.context].float().sum(-1) >= cfg.min_history
        return torch.where(enough, pred, torch.zeros_like(pred)).clamp(
            0.0, cfg.score_clip)

    def loss(self, params: dict, x: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        """Masked HUBER loss between the context-only forecast and the
        realized horizon tail, in normalized units. Huber, not MSE: a
        near-flat context before a load spike puts the horizon tail
        thousands of sigmas out, and squared error there hands the
        optimizer unbounded gradients."""
        cfg = self.cfg
        delta = 3.0
        xn, _, _ = self._normalize(x, valid)
        pred = self._predict_norm(params, xn, valid)
        y = xn[:, cfg.context:]
        vt = valid[:, cfg.context:].float()
        err = (pred - y).abs()
        hub = torch.where(err <= delta, 0.5 * err * err,
                          delta * (err - 0.5 * delta))
        return (hub * vt).sum() / vt.sum().clamp(min=1.0)

    def flops_per_event(self) -> float:
        """A few fused vector ops over the window — negligible next to
        the detectors, but non-zero so throughput accounting works."""
        return float(8 * self.cfg.window)
