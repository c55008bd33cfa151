"""Plain reference of `lstm-stream`: one LSTM step a reading, on state
kept a device, written again from the model's equations.

Warm state (from the last W readings of the warm history, all valid):
mean and population variance of the window, the window normalised by
√(var + 1e-6) and run through the LSTM from a zero state; the state is
(h, c), the standing prediction `pred = head(h)`, the mean, the variance
(at least 1e-6) and the count W.

Each reading v, in the order it was sent:

    xn    = (v − mean) / √(var + 1e-6)
    score = clip(|xn − pred|, 0, 50), or 0 while count < max(8, W/8)
    count = min(count + 1, W);  δ = v − mean
    mean += δ / count;  var += ((v − mean)·δ − var) / count
    (h, c) = cell((v − mean) / √(var + 1e-6), h, c);  pred = head(h)
"""

from __future__ import annotations

import torch

from swxbench.reference.lstm_cell import Cell, gate_flops, make_params  # noqa: F401

SCORE_CLIP = 50.0


def flops_per_event(widths: dict) -> float:
    """One cell step and the head a reading."""
    h = int(widths["hidden"])
    return gate_flops(h) + 2.0 * h


def scores(params: dict, widths: dict, values: torch.Tensor, n_warm: int,
           rdt: torch.dtype) -> torch.Tensor:
    """values [D, n_warm + N] float32, each device's readings in the order
    sent (warm history first) → the N scores [D, N] float32."""
    w = int(widths["window"])
    cell = Cell(params, rdt)
    values = values.float()
    warm = values[:, n_warm - w:n_warm]
    mean = warm.mean(dim=1)
    var = ((warm - mean[:, None]) ** 2).mean(dim=1)
    xn = (warm - mean[:, None]) / torch.sqrt(var + 1e-6)[:, None]
    d = values.shape[0]
    h = torch.zeros((d, cell.hidden), dtype=torch.float32,
                    device=values.device)
    c = torch.zeros_like(h)
    for t in range(w):
        h, c = cell.step(xn[:, t], h, c)
    pred = cell.head(h)
    var = var.clamp(min=1e-6)
    count = torch.full((d,), w, dtype=torch.int64, device=values.device)
    gate = max(8, w // 8)
    out = []
    for t in range(n_warm, values.shape[1]):
        v = values[:, t]
        x = (v - mean) / torch.sqrt(var + 1e-6)
        err = (x - pred).abs()
        out.append(torch.where(count >= gate, err,
                               torch.zeros_like(err)).clamp(0.0, SCORE_CLIP))
        count = (count + 1).clamp(max=w)
        delta = v - mean
        mean = mean + delta / count
        var = var + ((v - mean) * delta - var) / count
        h, c = cell.step((v - mean) / torch.sqrt(var + 1e-6), h, c)
        pred = cell.head(h)
    if not out:
        return values.new_zeros((d, 0))
    return torch.stack(out, dim=1)
