"""LSTM anomaly detector: the windowed next-step forecaster.

Self-supervised next-step forecaster over a device's recent telemetry
window; the anomaly score is the normalized one-step-ahead prediction
error at the newest point. Params are a plain dict in the JAX package's
`model.init` layout (`lstm0.{wx,wh,b}`, `head.{w,b}`), passed explicitly
to every call; the model instance holds config and its device only.

Matmuls round through bf16 (the compute dtype), state and accumulation
are float32; per-window normalization lets one set of weights serve
fleets with different baselines and scales.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from sitewhere_tpu_torch.models.common import dense_init, lstm_init, lstm_scan
from sitewhere_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class LstmConfig:
    window: int = 64          # input history length W
    hidden: int = 64
    layers: int = 1
    compute_dtype: Any = torch.bfloat16
    score_clip: float = 50.0  # scores are z-like; clip insanity


class LstmAnomalyModel:
    """Functional LSTM forecaster on `device` (the card unless named)."""

    name = "lstm"

    def __init__(self, cfg: LstmConfig = LstmConfig(), device=None):
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def fused(self) -> bool:
        """Does `score_fused` take the window kernel? A property of the
        configuration (single layer, bf16), decided once — never by
        catching a failure."""
        return self.cfg.layers == 1 and self.cfg.compute_dtype == torch.bfloat16

    # -- params ------------------------------------------------------------

    def init(self, gen: torch.Generator | None = None) -> dict:
        cfg = self.cfg
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        params = {}
        in_dim = 1
        for layer in range(cfg.layers):
            params[f"lstm{layer}"] = lstm_init(gen, in_dim, cfg.hidden,
                                               device=self.device)
            in_dim = cfg.hidden
        params["head"] = dense_init(gen, cfg.hidden, 1, device=self.device)
        return params

    # -- forward -----------------------------------------------------------

    def _normalize(self, x: torch.Tensor, valid: torch.Tensor):
        """Per-window masked mean/std (padding slots excluded)."""
        n = valid.sum(-1, keepdim=True).clamp(min=1.0)
        mu = (x * valid).sum(-1, keepdim=True) / n
        var = (((x - mu) * valid) ** 2).sum(-1, keepdim=True) / n
        sd = torch.sqrt(var + 1e-6)
        return (x - mu) / sd, mu, sd

    def _run_layers(self, params: dict, seq: torch.Tensor) -> torch.Tensor:
        cdt = self.cfg.compute_dtype
        seq = seq.to(cdt)
        for layer in range(self.cfg.layers):
            seq, _ = lstm_scan(params[f"lstm{layer}"], seq, cdt)
            seq = seq.to(cdt)
        return seq

    def _predictions(self, params: dict, xn: torch.Tensor) -> torch.Tensor:
        """One-step-ahead predictions for steps 1..W-1.  xn: [B, W] → [B, W-1]."""
        seq = self._run_layers(params, xn[:, :-1, None])
        head = params["head"]
        return (seq.float() @ head["w"] + head["b"])[..., 0]

    def _finalize(self, pred_last: torch.Tensor, xn: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
        """Shared scoring tail: |forecast error| at the newest step,
        short-history gate, clip — one implementation so `score` and
        `score_fused` cannot drift."""
        err = (pred_last - xn[:, -1]).abs()
        # rows with too little history can't be judged → score 0
        enough = valid.float().sum(-1) >= max(8, self.cfg.window // 8)
        return torch.where(enough, err, torch.zeros_like(err)).clamp(
            0.0, self.cfg.score_clip)

    def score(self, params: dict, x: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
        """Anomaly score per row: normalized |forecast error| at the newest
        step. x: [B, W] raw values; valid: [B, W] bool. → [B] float32."""
        xn, _, _ = self._normalize(x, valid.float())
        preds = self._predictions(params, xn)
        return self._finalize(preds[:, -1], xn, valid)

    def forecast(self, params: dict, x: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        """One-step-ahead point forecast in ORIGINAL units: [B, 1, 1].

        Runs the cell over ALL W observed steps and takes the output
        after the last one — the prediction of the next, unseen value."""
        xn, mu, sd = self._normalize(x, valid.float())
        seq = self._run_layers(params, xn[:, :, None])
        head = params["head"]
        pred_n = (seq[:, -1].float() @ head["w"] + head["b"])[:, 0]
        pred = pred_n * sd[:, 0] + mu[:, 0]
        return pred[:, None, None]

    def score_fused(self, params: dict, x: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
        """`score` with the recurrence in the fused window kernel
        (ops/lstm_kernel.py) for a single-layer bf16 model; any other
        configuration is `score`. Scoring needs only the LAST step's
        prediction, so the kernel writes back one [B, h] tensor."""
        from sitewhere_tpu_torch.ops.lstm_kernel import lstm_window_final

        if not self.fused:
            return self.score(params, x, valid)
        xn, _, _ = self._normalize(x, valid.float())
        h = lstm_window_final(params["lstm0"], xn[:, :-1],
                              self.cfg.compute_dtype)
        head = params["head"]
        pred = (h @ head["w"] + head["b"])[:, 0]
        return self._finalize(pred, xn, valid)

    def flops_per_event(self) -> float:
        """Approximate forward FLOPs to score ONE event (one window row):
        4 LSTM gates × 2 FLOPs/MAC per scan step, plus the head."""
        cfg = self.cfg
        h, steps = cfg.hidden, cfg.window - 1
        fl, in_dim = 0.0, 1
        for _ in range(cfg.layers):
            fl += steps * 8.0 * h * (in_dim + h)
            in_dim = h
        return fl + steps * 2.0 * h  # head projection
