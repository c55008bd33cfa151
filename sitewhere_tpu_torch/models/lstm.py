"""LSTM anomaly detectors: the windowed next-step forecaster and its
streaming twin (one cell step per event on device-resident state).

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

from sitewhere_tpu_torch.models.common import (
    _matmul_round,
    dense_init,
    lstm_init,
    lstm_scan,
)
from sitewhere_tpu_torch.ops.lstm_kernel import (
    KERNEL_HIDDEN,
    lstm_window_final,
)
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
        configuration (single layer, bf16, a hidden width the kernel is
        built for), decided once — never by catching a failure."""
        cfg = self.cfg
        return (cfg.layers == 1 and cfg.compute_dtype == torch.bfloat16
                and cfg.hidden in KERNEL_HIDDEN)

    @property
    def min_history(self) -> int:
        """Readings a device needs before its score counts (fewer: 0)."""
        return max(8, self.cfg.window // 8)

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
        enough = valid.float().sum(-1) >= self.min_history
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
        (ops/lstm_kernel.py) where `fused` holds; any other configuration
        is `score`. Scoring needs only the LAST step's prediction, so the
        kernel writes back one [B, h] tensor."""
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

    def loss(self, params: dict, x: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        """Masked next-step MSE over the window (self-supervised). The
        scan path, never the window kernel (which has no backward)."""
        v = valid.float()
        xn, _, _ = self._normalize(x, v)
        preds = self._predictions(params, xn)
        target = xn[:, 1:]
        mask = v[:, 1:] * v[:, :-1]
        se = (preds - target) ** 2 * mask
        return se.sum() / mask.sum().clamp(min=1.0)


class StreamingLstmModel(LstmAnomalyModel):
    """Event-native streaming twin of the windowed LSTM scorer.

    Per-device LSTM state (h, c per layer), the standing next-step
    prediction and running normalisation stats live on the device
    (scoring/stream.py), and each event costs ONE cell step — where the
    windowed model rescans W-1 steps per event — on the same weights.

    score(t) = |prediction made at t-1 − x_t| in normalised space, gated
    on history count like the windowed model. Normalisation uses
    per-device capped-count Welford stats (count capped at W), the
    streaming analog of the window mean/std, so params trained on the
    windowed objective serve directly. `score` (the whole-window query
    path) is inherited unchanged.
    """

    name = "lstm-stream"
    streaming = True

    def init_state(self, cap: int) -> dict:
        """Zero per-device streaming state for `cap` rows (callers add
        their own scratch row before passing a capacity here)."""
        h, dev = self.cfg.hidden, self.device
        state = {"pred": torch.zeros(cap, dtype=torch.float32, device=dev),
                 "mean": torch.zeros(cap, dtype=torch.float32, device=dev),
                 "var": torch.ones(cap, dtype=torch.float32, device=dev),
                 "count": torch.zeros(cap, dtype=torch.int32, device=dev)}
        for layer in range(self.cfg.layers):
            state[f"h{layer}"] = torch.zeros((cap, h), dtype=torch.float32,
                                             device=dev)
            state[f"c{layer}"] = torch.zeros((cap, h), dtype=torch.float32,
                                             device=dev)
        return state

    def _cell(self, params: dict, layer: int, x: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor):
        """One fused-gate LSTM step. x: [B, d_in] → (h, c) [B, hidden];
        both products rounded as `lstm_scan` rounds them."""
        cdt = self.cfg.compute_dtype
        p = params[f"lstm{layer}"]
        gates = (_matmul_round(x, p["wx"], cdt)
                 + _matmul_round(h, p["wh"], cdt) + p["b"])
        i, f, g, o = gates.split(self.cfg.hidden, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    def step_score(self, params: dict, rows: dict, v: torch.Tensor):
        """Score + advance gathered state rows for one event each.

        rows: state leaves indexed down to the event batch ([B] / [B, h]);
        v: [B] raw values. Returns (scores [B], new rows). The order is
        the reference's: score from the old stats and the standing
        prediction, then the Welford update, then the cell on the
        re-normalised value, then the head."""
        cfg = self.cfg
        mean, var, cnt = rows["mean"], rows["var"], rows["count"]
        xn = (v - mean) / torch.sqrt(var + 1e-6)
        enough = cnt >= self.min_history
        err = (xn - rows["pred"]).abs()
        score = torch.where(enough, err, torch.zeros_like(err)).clamp(
            0.0, cfg.score_clip)
        # capped-count Welford: behaves like the window-W mean/std once
        # count saturates (the streaming analog of _normalize)
        cnt1 = (cnt + 1).clamp(max=cfg.window)
        delta = v - mean
        mean1 = mean + delta / cnt1
        var1 = var + ((v - mean1) * delta - var) / cnt1
        x = ((v - mean1) / torch.sqrt(var1 + 1e-6))[:, None]
        out = dict(rows)
        out["mean"], out["var"], out["count"] = mean1, var1, cnt1
        for layer in range(cfg.layers):
            h, c = self._cell(params, layer, x, rows[f"h{layer}"],
                              rows[f"c{layer}"])
            out[f"h{layer}"], out[f"c{layer}"] = h, c
            x = h
        head = params["head"]
        out["pred"] = (x @ head["w"] + head["b"])[:, 0]
        return score, out

    def warm_state(self, params: dict, x: torch.Tensor,
                   valid: torch.Tensor) -> dict:
        """Build streaming state for `n` devices by replaying their host
        windows (x: [n, W] chronological left-padded, valid: [n, W]) —
        the warmup/recovery seed. Padding slots feed x=0 through the
        cell (they are not skipped), as the reference does."""
        cfg = self.cfg
        v = valid.float()
        n = v.sum(-1).clamp(min=1.0)
        mean = (x * v).sum(-1) / n
        var = (((x - mean[:, None]) * v) ** 2).sum(-1) / n
        xn = ((x - mean[:, None]) / torch.sqrt(var + 1e-6)[:, None]) * v
        state = self.init_state(x.shape[0])
        seq = xn[:, :, None]
        for layer in range(cfg.layers):
            seq, (h, c) = lstm_scan(params[f"lstm{layer}"], seq,
                                    cfg.compute_dtype)
            seq = seq.to(cfg.compute_dtype)
            state[f"h{layer}"], state[f"c{layer}"] = h, c
        head = params["head"]
        state["pred"] = (seq[:, -1, :].float() @ head["w"] + head["b"])[:, 0]
        state["mean"] = mean
        state["var"] = var.clamp(min=1e-6)
        state["count"] = v.sum(-1).to(torch.int32).clamp(max=cfg.window)
        return state

    def flops_per_event(self) -> float:
        """One cell step per event (vs a W-1-step rescan)."""
        cfg = self.cfg
        h = cfg.hidden
        fl, in_dim = 0.0, 1
        for _ in range(cfg.layers):
            fl += 8.0 * h * (in_dim + h)
            in_dim = h
        return fl + 2.0 * h
