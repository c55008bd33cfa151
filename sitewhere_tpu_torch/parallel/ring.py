"""Single-device attention over a device's telemetry window.

The JAX package's `parallel/ring.py` holds two things: ring attention,
which shards the time axis over a mesh and rotates K/V blocks between
devices, and `dense_attention_reference`, the O(W²)-memory version the
long-window model runs on one device. This module is the dense one.
Ring attention over a sequence axis is ROADMAP A.2, with the rest of
the mesh: `longwin` with a `mesh` raises.

Layout (as the reference's):
  q, k, v: [B, W, H, Dh]   valid: [B, W] (bool, or float with 1 = valid)
Scores are the product in the inputs' dtype (a bf16 product is rounded
to bf16), accumulated and softmaxed in float32; a row with no valid key
at all gives a zero output.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention → [B, W, H, Dh] float32."""
    B, W, H, Dh = q.shape
    scale = scale if scale is not None else Dh ** -0.5
    pos = torch.arange(W, device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores.to(q.dtype).float() * scale
    mask = (valid != 0)[:, None, None, :]
    if causal:
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # rows with no valid key at all: zero output (the reference's rule)
    w = w * mask.any(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float())
