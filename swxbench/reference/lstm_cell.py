"""The plain LSTM pieces both references share, written from the model's
equations; nothing of the program is imported or called.

A single-layer LSTM over a scalar input, gates fused in the order
i, f, g, o: `gates = x·wx + h·wh + b`, `c' = σ(f)·c + σ(i)·tanh(g)`,
`h' = σ(o)·tanh(c')`, then the head `h·w + b`. The configuration states
the compute dtype of the products (`compute_dtype`): their operands x, h,
wx and wh are rounded to it, and products, sums, gates, state and the
head are float32 (TF32 off). The control passes the next precision below
(`float8_e4m3fn` under bfloat16) in its place.
"""

from __future__ import annotations

import torch


def dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def make_params(widths: dict, seed: int, device) -> dict:
    """Random weights from `seed`, made on `device` in two calls, in the
    program's parameter layout (`lstm0.{wx,wh,b}`, `head.{w,b}`, float32
    as served): weights scaled by 1/√fan-in, the forget gate's bias 1."""
    h = int(widths["hidden"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_wx, n_wh, n_head = 4 * h, h * 4 * h, h
    flat = torch.randn(n_wx + n_wh + n_head, generator=gen,
                       dtype=torch.float32, device=device)
    wx = flat[:n_wx].reshape(1, 4 * h).clone()
    wh = (flat[n_wx:n_wx + n_wh].reshape(h, 4 * h) / h ** 0.5).contiguous()
    w_head = (flat[n_wx + n_wh:].reshape(h, 1) / h ** 0.5).contiguous()
    b = torch.zeros(4 * h, dtype=torch.float32, device=device)
    b[h:2 * h] = 1.0
    return {"lstm0": {"wx": wx, "wh": wh, "b": b},
            "head": {"w": w_head,
                     "b": torch.zeros(1, dtype=torch.float32, device=device)}}


def rounded(x: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
    return x.to(rdt).float()


class Cell:
    """The cell with its weights rounded once to the products' dtype."""

    def __init__(self, params: dict, rdt: torch.dtype):
        p = params["lstm0"]
        self.wx = rounded(p["wx"].reshape(1, -1), rdt)
        self.wh = rounded(p["wh"], rdt)
        self.b = p["b"].float()
        self.head_w = params["head"]["w"].float()
        self.head_b = params["head"]["b"].float()
        self.hidden = self.wh.shape[0]
        self.rdt = rdt

    def step(self, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
        """x [B] → (h, c) [B, hidden]."""
        gates = (rounded(x, self.rdt)[:, None] @ self.wx
                 + rounded(h, self.rdt) @ self.wh + self.b)
        i, f, g, o = gates.split(self.hidden, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    def head(self, h: torch.Tensor) -> torch.Tensor:
        return (h @ self.head_w + self.head_b)[:, 0]


def gate_flops(hidden: int) -> float:
    """One cell step's products over a scalar input, 2 FLOP a MAC."""
    return 8.0 * hidden * (1 + hidden)
