"""Shared model primitives: dense init and the fused-gate LSTM cell.

The fused i/f/g/o gate layout `[d_in, 4h]` / `[h, 4h]` is the JAX
package's (`models/common.py`), so weights move between the two packages
unchanged. State and gates are float32; matmul outputs are rounded
through the compute dtype like the reference scan path.
"""

from __future__ import annotations

import numpy as np
import torch


def dense_init(gen: torch.Generator, n_in: int, n_out: int,
               scale: float | None = None, device=None) -> dict:
    scale = scale if scale is not None else (1.0 / np.sqrt(n_in))
    w = torch.randn((n_in, n_out), generator=gen, dtype=torch.float32) * scale
    return {"w": w.to(device),
            "b": torch.zeros(n_out, dtype=torch.float32, device=device)}


def lstm_init(gen: torch.Generator, d_in: int, d: int, device=None) -> dict:
    """Fused i/f/g/o gate weights; forget-gate bias +1 (standard
    stabilization)."""
    wx = torch.randn((d_in, 4 * d), generator=gen, dtype=torch.float32) / np.sqrt(d_in)
    wh = torch.randn((d, 4 * d), generator=gen, dtype=torch.float32) / np.sqrt(d)
    b = torch.zeros(4 * d, dtype=torch.float32)
    b[d:2 * d] = 1.0
    return {"wx": wx.to(device), "wh": wh.to(device), "b": b.to(device)}


def _matmul_round(a: torch.Tensor, w: torch.Tensor, cdt) -> torch.Tensor:
    """`(a.astype(cdt) @ w.astype(cdt)).astype(f32)` as the reference
    writes it: operands in `cdt`, product summed in float32, the result
    rounded once to `cdt`. Spelled out in float32 so the CPU and the card
    round at the same place (a library bf16 matmul may not)."""
    a = a.to(cdt).float()
    w = w.to(cdt).float()
    return (a @ w).to(cdt).float()


def lstm_scan(params: dict, seq: torch.Tensor, cdt,
              h0: torch.Tensor | None = None, c0: torch.Tensor | None = None):
    """Run the LSTM over time. seq: [B, T, d_in] → (outputs [B, T, d],
    (h, c)). Matmuls in `cdt` with outputs rounded to `cdt`, gates and
    state in float32 — the reference scan path's numerics."""
    wx, wh, b = params["wx"], params["wh"], params["b"]
    d = wh.shape[0]
    B = seq.shape[0]
    h = h0 if h0 is not None else torch.zeros((B, d), dtype=torch.float32,
                                              device=seq.device)
    c = c0 if c0 is not None else torch.zeros((B, d), dtype=torch.float32,
                                              device=seq.device)
    outs = []
    for t in range(seq.shape[1]):
        gates = (_matmul_round(seq[:, t], wx, cdt)
                 + _matmul_round(h, wh, cdt) + b)
        i, f, g, o = gates.split(d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        outs.append(h)
    hs = torch.stack(outs, dim=1) if outs else seq.new_zeros((B, 0, d))
    return hs, (h, c)
