"""Plain reference of the windowed `lstm`: each reading is scored on its
device's last W readings, written again from the model's equations.

For a window x of W readings (the newest last, all valid): x normalised
by its mean and √(population variance + 1e-6), the LSTM run from a zero
state over the first W−1 normalised readings, `pred = head(h)`, and the
score `clip(|pred − xn[W−1]|, 0, 50)` (0 while fewer than max(8, W/8)
readings are valid, which the warm history rules out here).
"""

from __future__ import annotations

import torch

from swxbench.reference.lstm_cell import Cell, gate_flops, make_params  # noqa: F401

SCORE_CLIP = 50.0
BLOCK_ROWS = 1 << 17


def flops_per_event(widths: dict) -> float:
    """W−1 cell steps over the window and the head once: the one
    prediction the score needs."""
    h, w = int(widths["hidden"]), int(widths["window"])
    return (w - 1) * gate_flops(h) + 2.0 * h


def window_scores(cell: Cell, x: torch.Tensor) -> torch.Tensor:
    """x [B, W] → scores [B]."""
    mean = x.mean(dim=1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=1, keepdim=True)
    xn = (x - mean) / torch.sqrt(var + 1e-6)
    h = torch.zeros((x.shape[0], cell.hidden), dtype=torch.float32,
                    device=x.device)
    c = torch.zeros_like(h)
    for t in range(x.shape[1] - 1):
        h, c = cell.step(xn[:, t], h, c)
    return (cell.head(h) - xn[:, -1]).abs().clamp(0.0, SCORE_CLIP)


def scores(params: dict, widths: dict, values: torch.Tensor, n_warm: int,
           rdt: torch.dtype) -> torch.Tensor:
    """values [D, n_warm + N] float32, each device's readings in the order
    sent (warm history first, n_warm ≥ W − 1) → the N scores [D, N]."""
    w = int(widths["window"])
    cell = Cell(params, rdt)
    values = values.float()
    d, total = values.shape
    n = total - n_warm
    # the window ending at reading e, for every e past the warm history
    wins = values.unfold(1, w, 1)[:, n_warm - w + 1:, :].reshape(d * n, w)
    out = torch.empty(d * n, dtype=torch.float32, device=values.device)
    for lo in range(0, d * n, BLOCK_ROWS):
        out[lo:lo + BLOCK_ROWS] = window_scores(cell, wins[lo:lo + BLOCK_ROWS])
    return out.reshape(d, n)
