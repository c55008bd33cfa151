"""Long-window transformer forecaster.

A device's telemetry history as one long window: scalar embedding +
sinusoidal positions → L pre-LN causal transformer blocks (GLU
feed-forward) → per-position next-step quantile heads. On one device
attention is `parallel/ring.dense_attention`, O(W²) in memory: at W=512
the scores of a 1,024-row batch are [1024, 4, 512, 512] float32
(4.3 GB), so callers bound their buckets for long windows.

With a `mesh` the model runs sequence-parallel, as the reference's does
inside a `shard_map`: the time axis is cut over the devices of
`cfg.seq_axis` (`window % axis size == 0`), everything but attention
computes on each device's time block, and attention is ring attention
(`parallel/ring.ring_attention`), the K/V blocks rotating between the
axis's devices.

Scoring contract matches every registry model (`init`, `score`, `loss`
over `x[B, W]`, `valid[B, W]`): the anomaly score is the newest
observation's violation of the model's predicted quantile interval,
mirroring the TFT scorer, so the same rule-processing hook serves it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.utils._pytree import tree_map

from sitewhere_tpu_torch.models.common import _matmul_round, dense_init
from sitewhere_tpu_torch.parallel.mesh import split_blocks
from sitewhere_tpu_torch.parallel.ring import dense_attention, ring_attention
from sitewhere_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class LongWindowConfig:
    window: int = 512
    hidden: int = 32
    heads: int = 4
    layers: int = 2
    quantiles: tuple[float, ...] = (0.1, 0.5, 0.9)
    compute_dtype: Any = torch.bfloat16
    score_clip: float = 50.0
    min_history: int = 32
    seq_axis: str = "data"      # mesh axis the time dimension shards over


def _ln(x):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6)


class LongWindowModel:
    """Functional long-window forecaster on `device` (the card unless
    named); optional mesh → sequence parallel. Instances hold config
    (and mesh) only — params are always passed explicitly."""

    name = "longwin"

    def __init__(self, cfg: LongWindowConfig = LongWindowConfig(),
                 mesh: Optional[Any] = None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self._seq_devices = None
        if mesh is not None:
            assert cfg.window % mesh.shape[cfg.seq_axis] == 0, \
                "window must divide across the sequence axis"
            if mesh.process_count != 1 or mesh.device_type != \
                    self.device.type:
                raise ValueError(f"a sequence axis runs on this process's "
                                 f"{self.device.type} devices, not {mesh}")
            self._seq_devices = mesh.axis_devices(cfg.seq_axis)

    # -- params ------------------------------------------------------------

    def init(self, gen: torch.Generator | None = None) -> dict:
        cfg, dev = self.cfg, self.device
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        d = cfg.hidden
        params: dict = {
            "embed": dense_init(gen, 2, d, device=dev),   # (value, is-valid) → d
            "head": dense_init(gen, d, len(cfg.quantiles), device=dev),
        }
        for i in range(cfg.layers):
            params[f"block{i}"] = {
                "q": dense_init(gen, d, d, device=dev),
                "k": dense_init(gen, d, d, device=dev),
                "v": dense_init(gen, d, d, device=dev),
                "o": dense_init(gen, d, d, device=dev),
                "ff_in": dense_init(gen, d, 4 * d, device=dev),
                "ff_out": dense_init(gen, 2 * d, d, device=dev),
            }
        return params

    # -- forward -----------------------------------------------------------

    def _normalize(self, x, valid):
        n = valid.sum(-1, keepdim=True).clamp(min=1.0)
        mu = (x * valid).sum(-1, keepdim=True) / n
        var = (((x - mu) * valid) ** 2).sum(-1, keepdim=True) / n
        sd = torch.sqrt(var + 1e-6)
        return (x - mu) / sd, mu, sd

    def _stack(self, params, xns, valids, ring: bool) -> list:
        """Per-timestep stack over time blocks in order (`xns[i]`
        [B, T] normalized values, `valids[i]` [B, T] float, block i on
        its own device) → each block's quantile predictions for the NEXT
        step [B, T, Q]. Attention is dense over one block, or ring
        attention across the blocks."""
        cfg = self.cfg
        cdt = cfg.compute_dtype
        d, H = cfg.hidden, cfg.heads
        Dh = d // H
        B, T = xns[0].shape
        ps = [tree_map(lambda t, dv=xn.device: t.to(dv), params)
              for xn in xns]
        hx = []
        for i, (p, xn, valid) in enumerate(zip(ps, xns, valids)):
            dev = xn.device
            pos = i * T + torch.arange(T, device=dev)
            # sinusoidal positional features added to the scalar embedding
            freqs = torch.exp(-torch.arange(d // 2, device=dev)
                              * (8.0 / max(d // 2 - 1, 1)))
            ang = pos[:, None] * freqs[None, :]
            posenc = torch.cat([torch.sin(ang), torch.cos(ang)], -1)  # [T, d]
            feats = torch.stack([xn, valid.float()], -1)          # [B, T, 2]
            hx.append(_matmul_round(feats, p["embed"]["w"], cdt)
                      + p["embed"]["b"] + posenc[None])
        for layer in range(cfg.layers):
            qs, ks, vs = [], [], []
            for p, h in zip(ps, hx):
                blk = p[f"block{layer}"]
                hn = _ln(h)
                # the reference keeps q/k/v in the compute dtype
                qs.append(_matmul_round(hn, blk["q"]["w"], cdt).to(cdt)
                          .reshape(B, T, H, Dh))
                ks.append(_matmul_round(hn, blk["k"]["w"], cdt).to(cdt)
                          .reshape(B, T, H, Dh))
                vs.append(_matmul_round(hn, blk["v"]["w"], cdt).to(cdt)
                          .reshape(B, T, H, Dh))
            if ring:
                attns = ring_attention(qs, ks, vs, valids, causal=True)
            else:
                attns = [dense_attention(qs[0], ks[0], vs[0], valids[0],
                                         causal=True)]
            for i, (p, attn) in enumerate(zip(ps, attns)):
                blk = p[f"block{layer}"]
                h = hx[i] + _matmul_round(attn.reshape(B, T, d),
                                          blk["o"]["w"], cdt) + blk["o"]["b"]
                ff = (_matmul_round(_ln(h), blk["ff_in"]["w"], cdt)
                      + blk["ff_in"]["b"])
                a, g = ff.chunk(2, dim=-1)
                ff = a * torch.sigmoid(g)
                hx[i] = (h + _matmul_round(ff, blk["ff_out"]["w"], cdt)
                         + blk["ff_out"]["b"])
        return [_matmul_round(_ln(h), p["head"]["w"], cdt) + p["head"]["b"]
                for p, h in zip(ps, hx)]

    def _quantile_deltas(self, params, xn, valid):
        """Quantile predictions for the NEXT step at every position
        [B, T, Q]; sequence-parallel when a mesh is configured."""
        if self.mesh is None:
            return self._stack(params, [xn], [valid], ring=False)[0]
        devs = self._seq_devices
        blocks = self._stack(params, split_blocks(xn, devs),
                             split_blocks(valid, devs), ring=True)
        return torch.cat([b.to(xn.device) for b in blocks], dim=1)

    # -- registry contract -------------------------------------------------

    def score(self, params: dict, x: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
        """Anomaly score: the newest observation's violation of the
        quantile interval predicted at the previous step. [B, W] → [B]."""
        cfg = self.cfg
        v = valid.float()
        xn, _, _ = self._normalize(x, v)
        dq = self._quantile_deltas(params, xn, v)             # [B, W, Q]
        lo, mid, hi = (dq[:, -2, 0], dq[:, -2, len(cfg.quantiles) // 2],
                       dq[:, -2, -1])
        newest = xn[:, -1]
        width = (hi - lo).clamp(min=1e-3)
        over = (newest - hi).clamp(min=0.0) / width
        under = (lo - newest).clamp(min=0.0) / width
        err = (newest - mid).abs() / width
        score = over + under + 0.1 * err
        enough = v.sum(-1) >= cfg.min_history
        return torch.where(enough, score, torch.zeros_like(score)).clamp(
            0.0, cfg.score_clip)

    def flops_per_event(self) -> float:
        """Approximate forward FLOPs per scored window: per layer, the
        MLP/projection matmuls (~8 d*d per step) plus attention (4*W*d
        per step). A coarse estimate for throughput accounting."""
        cfg = self.cfg
        d, w = cfg.hidden, cfg.window
        per_layer = w * (8.0 * d * d + 4.0 * w * d)
        return cfg.layers * per_layer

    def loss(self, params: dict, x: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        """Pinball (quantile) loss of each position's next-step
        prediction against the realized value, masked to valid pairs."""
        cfg = self.cfg
        v = valid.float()
        xn, _, _ = self._normalize(x, v)
        dq = self._quantile_deltas(params, xn, v)             # [B, W, Q]
        pred = dq[:, :-1]                                     # predicts t+1
        target = xn[:, 1:, None]
        qs = torch.tensor(cfg.quantiles, dtype=torch.float32,
                          device=xn.device)[None, None, :]
        diff = target - pred
        pin = torch.maximum(qs * diff, (qs - 1.0) * diff)
        mask = (v[:, 1:] * v[:, :-1])[..., None]
        return (pin * mask).sum() / mask.sum().clamp(min=1.0)
