"""Plain reference of `tft`, the Temporal Fusion Transformer (Lim, Arık,
Loeff, Pfister, arXiv:1912.09363), as the pool serves it: each reading is
scored on its device's last W readings, written again from the paper's
equations and the served model's documented choices; nothing of the
program is imported or called.

One window x of W = context + horizon readings (the newest last, all
valid: the warm history fills every window):

- normalise x by the mean and √(population variance + 1e-6) of its
  context (the horizon is the target and stays out of the statistics);
- past inputs, at each context step: the value, its difference from the
  step before (0 at the first), the validity (1) and |difference|; known
  inputs, at every step: sin and cos of 2π·position/W; each input has its
  own linear embedding to d;
- a learned static vector s, through a GRN, is the static context c_s;
- variable selection (eq. 6-8) over the past and over the known inputs:
  softmax(GRN(flattened embeddings, c_s)) weighs one GRN per input;
- an LSTM encoder over the context from a zero state, its final state
  seeding an LSTM decoder over the horizon; gated skip (GLU, add,
  LayerNorm) back to the selected inputs;
- static enrichment: GRN(·, c_s) at every step;
- interpretable multi-head attention (eq. 13-16): per-head Q and K, one V
  shared by the heads, the heads' outputs averaged; queries at the
  horizon steps only, each causal over the W keys up to its own step;
- gated skip to the enriched horizon, a position-wise GRN, gated skip to
  the sequence layer's horizon, and a linear head to the quantiles;
- the score: the horizon's worst violation of the outer quantiles'
  interval, in half-widths (at least 0.01), put in σ units by the
  interval's normal quantile z: (1 + violation)·z where it is violated,
  else 0, clipped to [0, 50].

GRN(a, c) = LayerNorm(skip(a) + GLU(W2·ELU(W1·a + W3·c))), skip the
identity where the widths agree; LayerNorm over the last axis with
ε = 1e-6; GLU(u) = u₁·σ(u₂).

Where the served model departs from the paper (each followed here):

- one scalar reading a device: the four observed inputs above are derived
  from it, and sin/cos position are the known inputs;
- no static covariates: a learned static vector takes their place and
  feeds the selection networks and the enrichment through c_s; the
  encoder starts from a zero state (the paper's c_h and c_c are absent);
- attention queries at the horizon steps only;
- monotone quantiles: the first from the head, each next one the one
  before plus softplus of its head output;
- the anomaly score above in place of the quantile forecast;
- no dropout at inference.

Numerics: `rdt` is the product dtype at every place the program rounds,
each dense product and both attention products: the operands are
rounded to it, the product is summed in float32 and the result rounded
to it once. Everything else is float32 (TF32 off). The control passes
the next precision below (`float8_e4m3fn` under bfloat16) in its place.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import torch
import torch.nn.functional as F

SCORE_CLIP = 50.0
N_PAST = 4          # value, difference, validity, |difference|
N_KNOWN = 2         # sin, cos of the position
BLOCK_ROWS = 4096


def _dims(widths: dict) -> tuple[int, int, int, int, int]:
    w, h = int(widths["window"]), int(widths["horizon"])
    d, heads = int(widths["hidden"]), int(widths["heads"])
    return w, h, d, heads, len(widths.get("quantiles", (0.1, 0.5, 0.9)))


def _quantiles(widths: dict) -> tuple[float, ...]:
    return tuple(float(q) for q in widths.get("quantiles", (0.1, 0.5, 0.9)))


# -- the parameters, in the program's layout ---------------------------------

def _dense(n_in: int, n_out: int) -> dict:
    return {"w": ("randn", (n_in, n_out), 1.0 / math.sqrt(n_in)),
            "b": ("zeros", (n_out,))}


def _norm(d: int) -> dict:
    return {"scale": ("ones", (d,)), "bias": ("zeros", (d,))}


def _grn(d_in: int, d: int, d_out: int | None = None,
         context: bool = False) -> dict:
    d_out = d if d_out is None else d_out
    p = {"fc1": _dense(d_in, d), "fc2": _dense(d, d_out),
         "gate": _dense(d_out, 2 * d_out), "ln": _norm(d_out)}
    if d_in != d_out:
        p["skip"] = _dense(d_in, d_out)
    if context:
        p["ctx"] = _dense(d, d)
    return p


def _lstm(d_in: int, d: int) -> dict:
    return {"wx": ("randn", (d_in, 4 * d), 1.0 / math.sqrt(d_in)),
            "wh": ("randn", (d, 4 * d), 1.0 / math.sqrt(d)),
            "b": ("forget", (4 * d,), d)}


def _gate(d: int) -> dict:
    return {"gate": _dense(d, 2 * d), "ln": _norm(d)}


def layout(widths: dict) -> dict:
    """The parameter tree as the program keeps it, leaves as recipes."""
    _, _, d, heads, nq = _dims(widths)
    dh = d // heads
    return {
        "emb_past": [_dense(1, d) for _ in range(N_PAST)],
        "emb_fut": [_dense(1, d) for _ in range(N_KNOWN)],
        "static": ("randn", (d,), 0.02),
        "grn_static": _grn(d, d),
        "vsn_past": _grn(N_PAST * d, d, N_PAST, context=True),
        "vsn_past_var": [_grn(d, d) for _ in range(N_PAST)],
        "vsn_fut": _grn(N_KNOWN * d, d, N_KNOWN, context=True),
        "vsn_fut_var": [_grn(d, d) for _ in range(N_KNOWN)],
        "lstm_enc": _lstm(d, d),
        "lstm_dec": _lstm(d, d),
        "gate_seq": _gate(d),
        "grn_enrich": _grn(d, d, context=True),
        "attn_q": _dense(d, d),
        "attn_k": _dense(d, d),
        "attn_v": _dense(d, dh),
        "attn_o": _dense(dh, d),
        "gate_attn": _gate(d),
        "grn_final": _grn(d, d),
        "gate_out": _gate(d),
        "head": _dense(d, nq),
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _numel(shape) -> int:
    return math.prod(shape)


def param_count(widths: dict) -> int:
    return sum(_numel(leaf[1]) for leaf in _leaves(layout(widths)))


def make_params(widths: dict, seed: int, device) -> dict:
    """Random weights from `seed`, drawn on `device` in one call, in the
    program's layout (lists of dicts included), float32 as served: dense
    and LSTM weights N(0, 1)/√fan-in, biases 0 but the LSTM's forget gate
    at 1, LayerNorm scale 1 and bias 0, the static vector N(0, 0.02²)."""
    tree = layout(widths)
    n = sum(_numel(leaf[1]) for leaf in _leaves(tree) if leaf[0] == "randn")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
    at = [0]

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        kind, shape = node[0], node[1]
        if kind == "randn":
            k = _numel(shape)
            out = (flat[at[0]:at[0] + k].reshape(shape) * node[2]).contiguous()
            at[0] += k
            return out
        if kind == "ones":
            return torch.ones(shape, dtype=torch.float32, device=device)
        out = torch.zeros(shape, dtype=torch.float32, device=device)
        if kind == "forget":
            out[node[2]:2 * node[2]] = 1.0
        return out

    return build(tree)


# -- the forward, from the equations -----------------------------------------

def _r(x: torch.Tensor, rdt: torch.dtype) -> torch.Tensor:
    return x.to(rdt).float()


class _Weights:
    """Each product's weight rounded once to `rdt`."""

    def __init__(self, params: dict, rdt: torch.dtype):
        self.rdt = rdt
        self.p = params
        self._w: dict[int, torch.Tensor] = {}

    def w(self, t: torch.Tensor) -> torch.Tensor:
        key = id(t)
        if key not in self._w:
            self._w[key] = _r(t, self.rdt)
        return self._w[key]

    def dense(self, p: dict, x: torch.Tensor) -> torch.Tensor:
        return _r(_r(x, self.rdt) @ self.w(p["w"]), self.rdt) + p["b"]


def _layer_norm(p: dict, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["scale"] + p["bias"]


def _grn_apply(m: _Weights, p: dict, a: torch.Tensor,
               c: torch.Tensor | None = None) -> torch.Tensor:
    u = m.dense(p["fc1"], a)
    if c is not None:
        u = u + m.dense(p["ctx"], c)
    u = m.dense(p["gate"], m.dense(p["fc2"], F.elu(u)))
    skip = m.dense(p["skip"], a) if "skip" in p else a
    return _layer_norm(p["ln"], skip + F.glu(u, dim=-1))


def _gated_skip(m: _Weights, p: dict, x: torch.Tensor,
                skip: torch.Tensor) -> torch.Tensor:
    return _layer_norm(p["ln"], skip + F.glu(m.dense(p["gate"], x), dim=-1))


def _select(m: _Weights, p_sel: dict, p_vars: list, embs: list,
            c: torch.Tensor) -> torch.Tensor:
    """Variable selection over the inputs' embeddings ([R, T, d] each)."""
    weights = torch.softmax(
        _grn_apply(m, p_sel, torch.cat(embs, dim=-1), c[:, None, :]), dim=-1)
    out = 0.0
    for i, (pv, e) in enumerate(zip(p_vars, embs)):
        out = out + _grn_apply(m, pv, e) * weights[..., i:i + 1]
    return out


def _lstm_run(m: _Weights, p: dict, seq: torch.Tensor, h, c):
    """The LSTM over seq [R, T, d] from (h, c); gates in the order
    i, f, g, o, each of the two products rounded."""
    d = p["wh"].shape[0]
    out = []
    for t in range(seq.shape[1]):
        gates = (_r(_r(seq[:, t], m.rdt) @ m.w(p["wx"]), m.rdt)
                 + _r(_r(h, m.rdt) @ m.w(p["wh"]), m.rdt) + p["b"])
        i, f, g, o = gates.split(d, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1), h, c


def normalise(widths: dict, x: torch.Tensor) -> torch.Tensor:
    """x [R, W] → x by its context's mean and √(variance + 1e-6)."""
    wc = int(widths["window"]) - int(widths["horizon"])
    xc = x[:, :wc]
    count = torch.full_like(xc[:, :1], wc)      # the context's readings
    mu = xc.sum(-1, keepdim=True) / count
    var = ((xc - mu) ** 2).sum(-1, keepdim=True) / count
    return (x - mu) / torch.sqrt(var + 1e-6)


def selection(m: _Weights, widths: dict, xn: torch.Tensor):
    """The inputs, their embeddings, the static context and both
    variable selections: (c_s [R, d], past [R, Wc, d], known [R, H, d])."""
    w, hz, d, _, _ = _dims(widths)
    wc, p, rdt = w - hz, m.p, m.rdt
    rows = xn.shape[0]
    diff = torch.cat([torch.zeros_like(xn[:, :1]), xn[:, 1:] - xn[:, :-1]],
                     dim=1)[:, :wc]
    past = [xn[:, :wc], diff, torch.ones_like(diff), diff.abs()]
    pos = torch.arange(w, dtype=torch.float32, device=xn.device) / w
    known = [torch.sin(2 * math.pi * pos)[wc:],
             torch.cos(2 * math.pi * pos)[wc:]]
    past_e = [_r(_r(f, rdt)[..., None] * m.w(e["w"])[0], rdt) + e["b"]
              for f, e in zip(past, p["emb_past"])]
    known_e = [(_r(_r(f, rdt)[:, None] * m.w(e["w"])[0], rdt)
                + e["b"]).expand(rows, hz, d)
               for f, e in zip(known, p["emb_fut"])]
    c_s = _grn_apply(m, p["grn_static"], p["static"].expand(rows, d))
    return (c_s, _select(m, p["vsn_past"], p["vsn_past_var"], past_e, c_s),
            _select(m, p["vsn_fut"], p["vsn_fut_var"], known_e, c_s))


def sequence(m: _Weights, past: torch.Tensor,
             known: torch.Tensor) -> torch.Tensor:
    """The encoder over the context seeding the decoder over the horizon,
    gated back onto the selected inputs: [R, W, d]."""
    p = m.p
    zero = torch.zeros_like(past[:, 0])
    enc, h, c = _lstm_run(m, p["lstm_enc"], past, zero, zero)
    dec, _, _ = _lstm_run(m, p["lstm_dec"], known, h, c)
    return _gated_skip(m, p["gate_seq"], torch.cat([enc, dec], dim=1),
                       torch.cat([past, known], dim=1))


def attention(m: _Weights, widths: dict, seq: torch.Tensor,
              c_s: torch.Tensor) -> torch.Tensor:
    """Enrichment, attention at the horizon, the tail and the monotone
    quantiles: [R, H, Q]."""
    w, hz, d, heads, _ = _dims(widths)
    wc, dh, p, rdt = w - hz, d // heads, m.p, m.rdt
    rows = seq.shape[0]
    enriched = _grn_apply(m, p["grn_enrich"], seq, c_s[:, None, :])
    q = m.dense(p["attn_q"], enriched[:, wc:]).reshape(rows, hz, heads, dh)
    k = m.dense(p["attn_k"], enriched).reshape(rows, w, heads, dh)
    v = m.dense(p["attn_v"], enriched)                      # [R, W, dh]
    logits = _r(_r(q.transpose(1, 2), rdt)
                @ _r(k.permute(0, 2, 3, 1), rdt), rdt) / math.sqrt(dh)
    key = torch.arange(w, device=seq.device)
    allowed = key[None, :] <= (wc + torch.arange(hz, device=seq.device))[:, None]
    attn = torch.softmax(logits.masked_fill(~allowed, -1e9), dim=-1)
    heads_out = _r(_r(attn, rdt) @ _r(v, rdt)[:, None], rdt)   # [R, n, H, dh]
    attended = m.dense(p["attn_o"], heads_out.mean(dim=1))
    x_attn = _gated_skip(m, p["gate_attn"], attended, enriched[:, wc:])
    out = _gated_skip(m, p["gate_out"], _grn_apply(m, p["grn_final"], x_attn),
                      seq[:, wc:])
    raw = m.dense(p["head"], out)                           # [R, H, Q]
    return torch.cat([raw[..., :1], raw[..., :1]
                      + torch.cumsum(F.softplus(raw[..., 1:]), dim=-1)],
                     dim=-1)


def interval_score(widths: dict, quant: torch.Tensor,
                   xn: torch.Tensor) -> torch.Tensor:
    """The horizon's worst violation of the outer quantiles in σ units:
    [R]."""
    hz = int(widths["horizon"])
    qs = _quantiles(widths)
    lo, hi = quant[..., 0], quant[..., -1]
    y = xn[:, -hz:]
    half = ((hi - lo) * 0.5).clamp(min=1e-2)
    violation = (torch.maximum(lo - y, y - hi) / half).amax(dim=-1)
    z = -NormalDist().inv_cdf((1.0 - (qs[-1] - qs[0])) / 2.0)
    score = torch.where(violation > 0.0, (1.0 + violation) * z,
                        torch.zeros_like(violation))
    return score.clamp(0.0, SCORE_CLIP)


def window_scores(params: dict, widths: dict, x: torch.Tensor,
                  rdt: torch.dtype) -> torch.Tensor:
    """x [R, W] (all valid) → scores [R]."""
    m = _Weights(params, rdt)
    xn = normalise(widths, x)
    c_s, past, known = selection(m, widths, xn)
    quant = attention(m, widths, sequence(m, past, known), c_s)
    return interval_score(widths, quant, xn)


def scores(params: dict, widths: dict, values: torch.Tensor, n_warm: int,
           rdt: torch.dtype) -> torch.Tensor:
    """values [D, n_warm + N] float32, each device's readings in the order
    sent (warm history first, n_warm ≥ W − 1) → the N scores [D, N]."""
    w = int(widths["window"])
    values = values.float()
    d, total = values.shape
    n = total - n_warm
    if n <= 0:
        return values.new_zeros((d, 0))
    # the window ending at reading e, for every e past the warm history
    wins = values.unfold(1, w, 1)[:, n_warm - w + 1:, :].reshape(d * n, w)
    out = torch.empty(d * n, dtype=torch.float32, device=values.device)
    with torch.no_grad():
        for lo in range(0, d * n, BLOCK_ROWS):
            out[lo:lo + BLOCK_ROWS] = window_scores(
                params, widths, wins[lo:lo + BLOCK_ROWS], rdt)
    return out.reshape(d, n)


# -- operations and bytes -----------------------------------------------------

def _grn_macs(d_in: int, d: int, d_out: int | None = None) -> int:
    """Multiply-adds of one GRN application at one step, its context's
    product left out (that one is made once a window)."""
    d_out = d if d_out is None else d_out
    return (d_in * d + d * d_out + d_out * 2 * d_out
            + (d_in * d_out if d_in != d_out else 0))


def flops_per_event(widths: dict) -> float:
    """Every product and einsum of one window's forward, 2 FLOP a
    multiply-add: the embeddings, both selection networks, the static
    GRN and the three context products (once a window), both LSTMs, the
    gated skips, the enrichment, Q at the horizon and K, V at every step,
    both attention products over all W keys, the tail and the head."""
    w, hz, d, heads, nq = _dims(widths)
    wc, dh = w - hz, d // heads
    static = _grn_macs(d, d) + 3 * d * d             # c_s and its 3 uses
    past = wc * (N_PAST * d + _grn_macs(N_PAST * d, d, N_PAST)
                 + N_PAST * _grn_macs(d, d))
    known = hz * (N_KNOWN * d + _grn_macs(N_KNOWN * d, d, N_KNOWN)
                  + N_KNOWN * _grn_macs(d, d))
    lstm = w * 2 * d * 4 * d
    seq = w * (2 * d * d + _grn_macs(d, d) + d * d + d * dh)
    attention = 2 * heads * hz * w * dh
    tail = hz * (d * d + dh * d + 2 * d * d + _grn_macs(d, d) + 2 * d * d
                 + d * nq)
    return 2.0 * (static + past + known + lstm + seq + attention + tail)


def counts(widths: dict, rows: float) -> tuple[float, float]:
    """(FLOP, bytes) of `rows` real windows: `flops_per_event` each; each
    window's W float32 readings read and its score written once (float32),
    and the weights read once in the product dtype (2 bytes). Bucket
    padding is not work, so `rows` counts real rows only."""
    w = int(widths["window"])
    flops = rows * flops_per_event(widths)
    nbytes = rows * (4 * w + 4) + 2 * param_count(widths)
    return flops, nbytes
