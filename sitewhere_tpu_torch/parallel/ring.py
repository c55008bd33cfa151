"""Attention over a device's telemetry window: dense on one device, and
ring attention with the time axis sharded over a mesh axis.

Ring attention (the JAX package's `parallel/ring.py`; Liu et al. 2023,
blockwise online softmax from flash attention): the window's time axis
is cut into P blocks, one a device along the axis. Each device keeps its
query block while the K/V and validity blocks rotate P-1 hops around the
ring — a copy to the next shard's device stands in for JAX's `ppermute`
— and the online softmax folds each visiting block into the local
accumulator in float32. There is no P-th rotation: after P-1 hops every
block has visited every device. Peak memory a device is O(W/P) keys
instead of O(W).

Layout (as the reference's):
  q, k, v: [B, W, H, Dh]   valid: [B, W] (bool, or float with 1 = valid)
Scores are the product in the inputs' dtype (a bf16 product is rounded
to bf16), accumulated and softmaxed in float32; a row with no valid key
at all gives a zero output, in both forms.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from sitewhere_tpu_torch.parallel.mesh import split_blocks

NEG_INF = -1e30


def _scores(q, k, scale):
    """`[B, H, Tq, Tk]` products in the inputs' dtype, then float32."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    return s.to(q.dtype).float() * scale


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid: torch.Tensor, causal: bool = False,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention → [B, W, H, Dh] float32."""
    B, W, H, Dh = q.shape
    scale = scale if scale is not None else Dh ** -0.5
    pos = torch.arange(W, device=q.device)
    scores = _scores(q, k, scale)
    mask = (valid != 0)[:, None, None, :]
    if causal:
        mask = mask & (pos[None, None, None, :] <= pos[None, None, :, None])
    scores = scores.masked_fill(~mask, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    # rows with no valid key at all: zero output (the reference's rule)
    w = w * mask.any(-1, keepdim=True)
    return torch.einsum("bhqk,bkhd->bqhd", w, v.float())


def ring_attention(qs: Sequence[torch.Tensor], ks: Sequence[torch.Tensor],
                   vs: Sequence[torch.Tensor], valids: Sequence[torch.Tensor],
                   causal: bool = False,
                   scale: Optional[float] = None) -> list[torch.Tensor]:
    """Blockwise ring attention over P time blocks, block i on its own
    device (`qs[i].device`): q/k/v blocks `[B, T_local, H, Dh]`, validity
    `[B, T_local]`, in time order. Returns the P output blocks
    `[B, T_local, H, Dh]` float32, each on its block's device."""
    P = len(qs)
    B, T_l, H, Dh = qs[0].shape
    scale = scale if scale is not None else Dh ** -0.5
    devices = [q.device for q in qs]
    ar = [torch.arange(T_l, device=d) for d in devices]
    q_pos = [i * T_l + ar[i] for i in range(P)]
    # online-softmax state a device: accumulator o, running max m,
    # running denominator l
    o = [torch.zeros((B, T_l, H, Dh), dtype=torch.float32, device=d)
         for d in devices]
    m = [torch.full((B, H, T_l), NEG_INF, dtype=torch.float32, device=d)
         for d in devices]
    l = [torch.zeros((B, H, T_l), dtype=torch.float32, device=d)
         for d in devices]
    k_cur, v_cur, valid_cur = list(ks), list(vs), list(valids)
    for step in range(P):
        for i in range(P):
            owner = (i - step) % P           # whose block is visiting
            scores = _scores(qs[i], k_cur[i], scale)
            mask = (valid_cur[i] != 0)[:, None, None, :]
            if causal:
                k_pos = owner * T_l + ar[i]
                mask = mask & (k_pos[None, None, None, :]
                               <= q_pos[i][None, None, :, None])
            scores = scores.masked_fill(~mask, NEG_INF)
            new_m = torch.maximum(m[i], scores.amax(-1))
            corr = torch.exp(m[i] - new_m)
            p = torch.exp(scores - new_m[..., None])
            # a fully masked row (all NEG_INF so far) must not contribute
            p = p.masked_fill(scores <= NEG_INF / 2, 0.0)
            l[i] = l[i] * corr + p.sum(-1)
            pv = torch.einsum("bhqk,bkhd->bqhd", p, v_cur[i].float())
            o[i] = o[i] * corr.transpose(1, 2)[..., None] + pv
            m[i] = new_m
        if step < P - 1:
            # rotate one hop: block i moves to device i + 1
            k_cur = [k_cur[(i - 1) % P].to(devices[i]) for i in range(P)]
            v_cur = [v_cur[(i - 1) % P].to(devices[i]) for i in range(P)]
            valid_cur = [valid_cur[(i - 1) % P].to(devices[i])
                         for i in range(P)]
    return [o[i] / l[i].clamp(min=1e-30).transpose(1, 2)[..., None]
            for i in range(P)]


def ring_attention_sharded(q, k, v, valid, mesh, seq_axis: str,
                           causal: bool = False) -> torch.Tensor:
    """Host-facing form: shard the TIME axis of q/k/v/valid over mesh
    axis `seq_axis` (its devices at index 0 of the other axes), run ring
    attention and return [B, W, H, Dh] float32 on q's device. W must
    divide by the axis size."""
    devices = mesh.axis_devices(seq_axis)
    out = ring_attention(split_blocks(q, devices), split_blocks(k, devices),
                         split_blocks(v, devices), split_blocks(valid, devices),
                         causal=causal)
    return torch.cat([b.to(q.device) for b in out], dim=1)
