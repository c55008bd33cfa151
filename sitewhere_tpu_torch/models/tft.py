"""Temporal Fusion Transformer forecaster (config 3 [BASELINE.json]).

Multi-horizon quantile forecasting over a device's telemetry window,
following Lim et al. 2021 (TFT): per-feature embeddings → variable
selection networks → LSTM encoder/decoder → gated skip connections →
static enrichment → interpretable multi-head attention → position-wise
GRN → quantile heads. Mounted at the same rule-processing hook as the
LSTM detector; the anomaly score is the newest observations' violation
of the predicted quantile interval, so one model serves both
forecasting (config 3) and anomaly alerting.

The same functional protocol as every registry model: `init`, and
`score/loss(params, x[B, W], valid[B, W])` — `torch.func.vmap`
friendly (static shapes, no Python branching on data), so the pool
scores a stacked tenant axis exactly as it does the LSTM's. Params keep
the JAX `init` layout, lists of dicts included (`emb_past`,
`vsn_past_var`, ...).

The forward is written once, over an op table of `ops/tft_fused.py`:
products round through the compute dtype where the reference casts
(operands and result), softmax, layernorm and state stay float32, and
the dense layers (each its product and the pointwise work after it) and
the pointwise work between the other products are the table's ops. Where
`tft_fused.engaged` holds (on the card, no param requiring grad, bf16 or
float16 products) the table is `OPS`, whose ops launch the K3 kernels;
elsewhere, the CPU and training included, it is `PLAIN`, their plain
versions, bit for bit the same.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from sitewhere_tpu_torch.kernel.tracing import profiled
from sitewhere_tpu_torch.models.common import dense_init, lstm_init
from sitewhere_tpu_torch.ops import tft_fused as k3
from sitewhere_tpu_torch.utils import resolve_device


@dataclass(frozen=True)
class TftConfig:
    window: int = 64           # total input length W (context + horizon)
    horizon: int = 8           # forecast steps H (scored region)
    hidden: int = 32           # model width d
    heads: int = 4
    quantiles: tuple[float, ...] = (0.1, 0.5, 0.9)
    compute_dtype: Any = torch.bfloat16
    score_clip: float = 50.0
    min_history: int = 16      # valid context steps needed to score

    @property
    def context(self) -> int:
        return self.window - self.horizon


# -- the blocks, over an op table (ops/tft_fused.py) -------------------------
# Each takes `ops`, the forward's op table, `r`, the block's params with
# their weights already rounded (`k3.rounded_weights`), its input both as
# float32 and rounded (the products' operand), and `kind`, the rounding;
# and gives back what its consumers read: the float32 value, its rounded
# copy, or both (`outs`).


def _ln_init(d, device):
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def _ln(ops, p, x, kind, outs):
    mu = x.mean(-1, keepdim=True)
    var = ops.sqdev(x, mu, kind)[0].mean(-1, keepdim=True)
    return ops.ln(x, mu, var, p["scale"], p["bias"], outs, kind)


def _grn_init(gen, d_in, d, d_out=None, with_context=False, device=None):
    """Gated residual network params (TFT eq. 2-5)."""
    d_out = d_out if d_out is not None else d
    p = {
        "fc1": dense_init(gen, d_in, d, device=device),
        "fc2": dense_init(gen, d, d_out, device=device),
        "gate": dense_init(gen, d_out, 2 * d_out, device=device),  # GLU
        "ln": _ln_init(d_out, device),
    }
    if d_in != d_out:
        p["skip"] = dense_init(gen, d_in, d_out, device=device)
    if with_context:
        p["ctx"] = dense_init(gen, d, d, device=device)
    return p


def _grn_sum(ops, r, a, a_r, kind, ctx_r=None):
    """A GRN up to its LayerNorm: skip(a) + GLU(W2 ELU(W1 a + W3 c))."""
    ctx = ((ctx_r @ r["ctx"]["w"], r["ctx"]["b"]) if ctx_r is not None
           else (None, None))
    (u,) = ops.dense(a_r, r["fc1"]["w"], r["fc1"]["b"], *ctx, True,
                     k3.ROUNDED, kind)
    (u,) = ops.dense(u, r["fc2"]["w"], r["fc2"]["b"], None, None, False,
                     k3.ROUNDED, kind)
    g = u @ r["gate"]["w"]
    if "skip" in r:
        return ops.gate(g, r["gate"]["b"], a_r @ r["skip"]["w"],
                        r["skip"]["b"], kind)[0]
    return ops.gate(g, r["gate"]["b"], a, None, kind)[0]


def _grn(ops, r, a, a_r, kind, outs, ctx_r=None):
    """GRN(a, c) = LayerNorm(skip(a) + GLU(W2 ELU(W1 a + W3 c)))."""
    return _ln(ops, r["ln"], _grn_sum(ops, r, a, a_r, kind, ctx_r), kind,
               outs)


def _glu_addnorm_init(gen, d, device):
    return {"gate": dense_init(gen, d, 2 * d, device=device),
            "ln": _ln_init(d, device)}


def _glu_addnorm(ops, r, x_r, skip, kind, outs):
    (s,) = ops.gate(x_r @ r["gate"]["w"], r["gate"]["b"], skip, None, kind)
    return _ln(ops, r["ln"], s, kind, outs)


def _vsn(ops, r_sel, r_vars, r_emb, feats, ctx_r, kind):
    """Embeddings and variable selection (TFT eq. 6-8) of `feats`
    [B, T, nvars]: (selected [B, T, d], rounded)."""
    raw, flat_r, *each_r = ops.embed(feats, [e["w"] for e in r_emb],
                                     [e["b"] for e in r_emb], kind)
    (sel,) = _grn(ops, r_sel, None, flat_r, kind, k3.RAW, ctx_r=ctx_r)
    del flat_r            # each rounded copy goes once its product ran
    w = torch.softmax(sel, dim=-1)
    sums = []
    for i, r_var in enumerate(r_vars):
        sums.append(_grn_sum(ops, r_var, raw[:, :, i], each_r[i], kind))
        each_r[i] = None
    mus = [s.mean(-1, keepdim=True) for s in sums]
    var = [ops.sqdev(s, m, kind)[0].mean(-1, keepdim=True)
           for s, m in zip(sums, mus)]
    return ops.vsn(sums, mus, var, [p["ln"]["scale"] for p in r_vars],
                   [p["ln"]["bias"] for p in r_vars], w, kind)


# `lstm_scan` and `_einsum_round` keep the names and arguments that the
# benchmark's planted faults patch (`swxbench/tests/test_swxbench_tft.py`);
# `at` is the pair (op table, rounding kind).


def lstm_scan(r, seq_r, at, h0=None, c0=None):
    """The LSTM from the rounded input `seq_r`: the input's products for
    every step as one product, then in one `ops.lstm` call a step's `h·wh`
    product and its cell. Returns (rounded h at every step, (the last
    rounded h, c))."""
    hs, h_r, c = at[0].lstm(seq_r @ r["wx"], r["wh"], r["b"], h0, c0, at[1])
    return hs, (h_r, c)


def _einsum_round(eq, a_r, b_r, at):
    """The product `eq` of rounded operands, rounded through `round`."""
    return at[0].round(torch.einsum(eq, a_r, b_r), at[1])[0]


class TftForecaster:
    """Functional TFT on `device` (the card unless named). Instances
    hold config only; params are a tree passed explicitly."""

    name = "tft"

    # observed past features: value, first difference; known features
    # (past+future): sin/cos relative position (the univariate-telemetry
    # stand-ins for TFT's observed/known covariate split)
    N_PAST_VARS = 4
    N_FUT_VARS = 2

    def __init__(self, cfg: TftConfig = TftConfig(), device=None):
        if cfg.horizon >= cfg.window:
            raise ValueError("horizon must be < window")
        if cfg.heads < 1 or cfg.hidden % cfg.heads != 0:
            raise ValueError(
                f"hidden ({cfg.hidden}) must be a positive multiple of "
                f"heads ({cfg.heads})")
        if (len(cfg.quantiles) < 2
                or any(q2 <= q1 for q1, q2 in zip(cfg.quantiles,
                                                  cfg.quantiles[1:]))
                or cfg.quantiles[0] <= 0.0 or cfg.quantiles[-1] >= 1.0):
            # strictly increasing inside (0, 1): duplicates make z_outer 0
            # (scores silently constant) and 0/1 endpoints hit ppf's domain
            raise ValueError(
                "quantiles must be strictly increasing within (0, 1)")
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- params ------------------------------------------------------------

    def init(self, gen: torch.Generator | None = None) -> dict:
        cfg, dev = self.cfg, self.device
        gen = gen if gen is not None else torch.Generator().manual_seed(0)
        d, nq = cfg.hidden, len(cfg.quantiles)
        return {
            # per-variable scalar → d embeddings
            "emb_past": [dense_init(gen, 1, d, device=dev)
                         for _ in range(self.N_PAST_VARS)],
            "emb_fut": [dense_init(gen, 1, d, device=dev)
                        for _ in range(self.N_FUT_VARS)],
            # learned static context (no static covariates in the fleet
            # case; a learned vector keeps TFT's conditioning structure)
            "static": (torch.randn(d, generator=gen, dtype=torch.float32)
                       * 0.02).to(dev),
            "grn_static": _grn_init(gen, d, d, device=dev),
            # variable selection: GRN over flattened embeddings → softmax
            "vsn_past": _grn_init(gen, self.N_PAST_VARS * d, d,
                                  d_out=self.N_PAST_VARS, with_context=True,
                                  device=dev),
            "vsn_past_var": [_grn_init(gen, d, d, device=dev)
                             for _ in range(self.N_PAST_VARS)],
            "vsn_fut": _grn_init(gen, self.N_FUT_VARS * d, d,
                                 d_out=self.N_FUT_VARS, with_context=True,
                                 device=dev),
            "vsn_fut_var": [_grn_init(gen, d, d, device=dev)
                            for _ in range(self.N_FUT_VARS)],
            # sequence-to-sequence layer
            "lstm_enc": lstm_init(gen, d, d, device=dev),
            "lstm_dec": lstm_init(gen, d, d, device=dev),
            "gate_seq": _glu_addnorm_init(gen, d, dev),
            # static enrichment + temporal self-attention
            "grn_enrich": _grn_init(gen, d, d, with_context=True, device=dev),
            "attn_q": dense_init(gen, d, d, device=dev),
            "attn_k": dense_init(gen, d, d, device=dev),
            "attn_v": dense_init(gen, d, d // cfg.heads, device=dev),  # shared V
            "attn_o": dense_init(gen, d // cfg.heads, d, device=dev),
            "gate_attn": _glu_addnorm_init(gen, d, dev),
            "grn_final": _grn_init(gen, d, d, device=dev),
            "gate_out": _glu_addnorm_init(gen, d, dev),
            "head": dense_init(gen, d, nq, device=dev),
        }

    # -- features ----------------------------------------------------------

    def _normalize(self, x, valid):
        """Masked mean/std over the CONTEXT region only (the horizon tail
        is the prediction target; its stats must not leak)."""
        cfg = self.cfg
        v = valid[:, :cfg.context].float()
        xc = x[:, :cfg.context]
        n = v.sum(-1, keepdim=True).clamp(min=1.0)
        mu = (xc * v).sum(-1, keepdim=True) / n
        var = (((xc - mu) * v) ** 2).sum(-1, keepdim=True) / n
        sd = torch.sqrt(var + 1e-6)
        return (x - mu) / sd, mu, sd

    def _known_features(self, B, device):
        """sin/cos relative position over the full window: [W, 2]."""
        w = self.cfg.window
        pos = torch.arange(w, dtype=torch.float32, device=device) / w
        feats = torch.stack([torch.sin(2 * math.pi * pos),
                             torch.cos(2 * math.pi * pos)], dim=-1)
        return feats.expand(B, w, 2)

    # -- forward -----------------------------------------------------------

    def _forward(self, params, xn, valid):
        """Normalized window → (quantiles [B, H, Q], attention
        [B, Hd, H, W]) through the op table `k3.table` picks. While a
        profiler runs, a range names each stage: `tft.select` (the weights'
        rounding, the static GRN and both variable selections),
        `tft.seq2seq` (the encoder and decoder LSTMs and their gated skip)
        and `tft.attend` (enrichment, attention, the position-wise GRN and
        the heads)."""
        cdt = self.cfg.compute_dtype
        ops, kind = k3.table(params, xn, cdt), k3.ROUNDINGS[cdt]
        with profiled("tft.select"):
            r = k3.rounded_weights(ops, params, kind)
            static, past, fut = self._select(ops, r, xn, valid, kind)
        with profiled("tft.seq2seq"):
            seq = self._seq2seq(ops, r, past, fut, kind)
        with profiled("tft.attend"):
            return self._attend(ops, r, seq, static[1], valid, kind)

    # -- the stages ----------------------------------------------------------
    # Each takes the op table, `r` (the params with the weights rounded) and
    # the rounding kind; its tensors are (float32, rounded) pairs where a
    # product reads them.

    def _select(self, ops, r, xn, valid, kind):
        """((static context [B, d], rounded), (selected past [B, Wc, d],
        rounded), (selected future [B, H, d], rounded))."""
        B = xn.shape[0]
        Wc, d = self.cfg.context, self.cfg.hidden
        a = r["static"].expand(B, d)
        static = _grn(ops, r["grn_static"], a, ops.round(a, kind)[0], kind,
                      k3.BOTH)
        # observed past features (value, masked delta, validity, |delta|);
        # horizon values are masked out — the model must not see its own
        # target
        v = valid.float()
        delta = torch.diff(xn, dim=-1, prepend=xn[:, :1])
        past_feats = torch.stack(
            [xn * v, delta * v, v, delta.abs() * v], dim=-1)[:, :Wc]
        fut_feats = self._known_features(B, xn.device)[:, Wc:]
        ctx_r = static[1][:, None, :]
        past = _vsn(ops, r["vsn_past"], r["vsn_past_var"], r["emb_past"],
                    past_feats, ctx_r, kind)
        fut = _vsn(ops, r["vsn_fut"], r["vsn_fut_var"], r["emb_fut"],
                   fut_feats, ctx_r, kind)
        return static, past, fut

    def _seq2seq(self, ops, r, past, fut, kind):
        """The LSTM encoder over the context seeding the decoder over the
        horizon, gated back onto the selected inputs: (sequence [B, W, d],
        rounded)."""
        enc, (h_r, c) = lstm_scan(r["lstm_enc"], past[1], (ops, kind))
        dec, _ = lstm_scan(r["lstm_dec"], fut[1], (ops, kind), h0=h_r, c0=c)
        seq_r = torch.cat([enc, dec], dim=1)       # the outputs, rounded
        skip = torch.cat([past[0], fut[0]], dim=1)
        return _glu_addnorm(ops, r["gate_seq"], seq_r, skip, kind, k3.BOTH)

    def _attend(self, ops, r, seq, static_r, valid, kind):
        """Static enrichment, attention at the horizon and the tail:
        (quantiles [B, H, Q], attention [B, Hd, H, W])."""
        cfg = self.cfg
        B, W = valid.shape
        Wc, H, d, nh = cfg.context, cfg.horizon, cfg.hidden, cfg.heads
        dh = d // nh
        enriched, enriched_r = _grn(ops, r["grn_enrich"], seq[0], seq[1],
                                    kind, k3.BOTH, ctx_r=static_r[:, None, :])
        # interpretable multi-head attention: per-head Q/K, SHARED value
        # head (Lim et al. §4.4) — queries are the horizon positions only
        (q,) = ops.dense(enriched_r[:, Wc:].contiguous(), r["attn_q"]["w"],
                         r["attn_q"]["b"], None, None, False, k3.ROUNDED, kind)
        (k,) = ops.dense(enriched_r, r["attn_k"]["w"], r["attn_k"]["b"],
                         None, None, False, k3.ROUNDED, kind)
        (val,) = ops.dense(enriched_r, r["attn_v"]["w"], r["attn_v"]["b"],
                           None, None, False, k3.ROUNDED, kind)
        q = q.reshape(B, H, nh, dh).transpose(1, 2)          # [B, nh, H, dh]
        k = k.reshape(B, W, nh, dh).transpose(1, 2)          # [B, nh, W, dh]
        # causal + validity mask: horizon step i sits at absolute Wc+i and
        # may attend to positions <= Wc+i; invalid past steps are masked
        (logits,) = ops.logits(torch.einsum("bnqd,bnkd->bnqk", q, k),
                               valid[:, None, None, :], Wc,
                               float(np.sqrt(dh)), kind)
        attn = torch.softmax(logits, dim=-1)
        ctx_h = _einsum_round("bnqk,bkd->bnqd", ops.round(attn, kind)[0],
                              val, (ops, kind))
        (ctx,) = ops.round(ctx_h.mean(dim=1), kind)         # head-mean
        (attn_out,) = ops.dense(ctx, r["attn_o"]["w"], r["attn_o"]["b"],
                                None, None, False, k3.ROUNDED, kind)
        x_attn = _glu_addnorm(ops, r["gate_attn"], attn_out,
                              enriched[:, Wc:], kind, k3.BOTH)
        (ff,) = _grn(ops, r["grn_final"], *x_attn, kind, k3.ROUNDED)
        (out,) = _glu_addnorm(ops, r["gate_out"], ff, seq[0][:, Wc:], kind,
                              k3.ROUNDED)
        (quants,) = ops.dense(out, r["head"]["w"], r["head"]["b"], None,
                              None, False, k3.RAW, kind)       # [B, H, Q]
        return _monotone(quants), attn

    # -- public API --------------------------------------------------------

    def forecast(self, params: dict, x: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
        """Quantile forecasts in ORIGINAL units: [B, H, Q] (config 3)."""
        xn, mu, sd = self._normalize(x, valid)
        quants, _ = self._forward(params, xn, valid)
        return quants * sd[..., None] + mu[..., None]

    def attention(self, params: dict, x: torch.Tensor,
                  valid: torch.Tensor) -> torch.Tensor:
        """Interpretability surface: attention weights [B, heads, H, W]."""
        xn, _, _ = self._normalize(x, valid)
        _, attn = self._forward(params, xn, valid)
        return attn

    def forecast_with_attention(self, params: dict, x: torch.Tensor,
                                valid: torch.Tensor):
        """(forecast [B, H, Q] in original units, attention
        [B, heads, H, W]) from ONE forward pass — the query surface
        uses this so attention doesn't double the compute."""
        xn, mu, sd = self._normalize(x, valid)
        quants, attn = self._forward(params, xn, valid)
        return quants * sd[..., None] + mu[..., None], attn

    def score(self, params: dict, x: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
        """Anomaly score: worst violation of the predicted outer-quantile
        interval by the observed horizon tail, in interval half-widths
        (z-like for a Gaussian process ⇒ same thresholds as the LSTM/
        zscore detectors). x: [B, W], valid: [B, W] → [B]."""
        cfg = self.cfg
        xn, _, _ = self._normalize(x, valid)
        quants, _ = self._forward(params, xn, valid)
        lo, hi = quants[..., 0], quants[..., -1]             # [B, H]
        y = xn[:, cfg.context:]
        vt = valid[:, cfg.context:].float()
        half = ((hi - lo) * 0.5).clamp(min=1e-2)
        violation = torch.maximum(lo - y, y - hi)
        viol_z = (violation / half).masked_fill(vt <= 0, -math.inf).amax(-1)
        # sigma units: the interval edge sits at z_outer (1.28 for an 80%
        # interval), so a point viol_z half-widths past it has predictive
        # z = (1 + viol_z) * z_outer — keeps thresholds interchangeable
        # with the lstm/zscore detectors
        z_outer = float(-_norm_ppf((1.0 - (cfg.quantiles[-1]
                                           - cfg.quantiles[0])) / 2.0))
        score = torch.where(viol_z > 0.0, (1.0 + viol_z) * z_outer,
                            torch.zeros_like(viol_z))
        enough = valid[:, :cfg.context].float().sum(-1) >= cfg.min_history
        enough = enough & (vt.sum(-1) > 0)
        return torch.where(enough, score, torch.zeros_like(score)).clamp(
            0.0, cfg.score_clip)

    def flops_per_event(self) -> float:
        """Approximate forward FLOPs per scored window: VSN + GRN stack
        (~a dozen d*d matmuls per step), encoder/decoder LSTMs, and the
        interpretable attention (QK^T + AV over the full window). A
        coarse estimate for throughput accounting, not a profiler."""
        cfg = self.cfg
        d, w = cfg.hidden, cfg.window
        per_step = 24.0 * d * d + 16.0 * d * d  # GRN stack + LSTM gates
        attn = 4.0 * w * w * d / max(w, 1)      # amortized per step
        return w * (per_step + attn)

    def loss(self, params: dict, x: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
        """Masked quantile (pinball) loss over the horizon region."""
        cfg = self.cfg
        xn, _, _ = self._normalize(x, valid)
        quants, _ = self._forward(params, xn, valid)
        y = xn[:, cfg.context:, None]                        # [B, H, 1]
        qs = torch.tensor(cfg.quantiles, dtype=torch.float32,
                          device=xn.device)
        err = y - quants
        pinball = torch.maximum(qs * err, (qs - 1.0) * err)  # [B, H, Q]
        mask = valid[:, cfg.context:, None].float()
        return (pinball * mask).sum() / (
            mask.sum() * len(cfg.quantiles)).clamp(min=1.0)


def _monotone(quants):
    """Monotone quantiles: cumulative softplus offsets from the first."""
    base = quants[..., :1]
    steps = F.softplus(quants[..., 1:])
    return torch.cat([base, base + torch.cumsum(steps, dim=-1)], dim=-1)


def _norm_ppf(p: float) -> float:
    """Scalar standard-normal inverse CDF (Acklam approximation) — host
    side only (used for the score's sigma conversion constant)."""
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow = 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        return (((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q
                + c[5]) / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > 1 - plow:
        return -_norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    return (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r
            + a[5]) * q / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r
                            + b[4]) * r + 1)
