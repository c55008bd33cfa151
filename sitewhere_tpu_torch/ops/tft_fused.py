"""The TFT forward's pointwise work as hand-written CUDA kernels (K3).

Replaces no Pallas kernel: the JAX package leaves the Temporal Fusion
Transformer's forward to XLA. The reference rounds each product to its
bf16 compute dtype; the port spells the products out in float32, and at
the electricity widths the pointwise passes around them, each its own
launch, took twice the card's product time. `csrc/tft_fused.cu` (whose
header states the design and the bound: bytes) computes each chain of
them as one pass beside the float32 products, which stay PyTorch's.

The forward (`models/tft.py`) is written once, over an op table (`Table`):

- `OPS`, the `torch.library` custom ops (`swx::tft_*`), each with a `vmap`
  rule, so the pool's `vmap(model.score)` over the stacked tenant axis
  hands the kernel the tenant axis as its leading row dimension. On the
  card an op launches its kernel; anywhere else it runs its plain
  version. `on_card` is the one test of where the tensors lie.
- `PLAIN`, each op's plain version: plain PyTorch, which autograd and
  `vmap` go through, and which rounds to any compute dtype of the model,
  float32 (the identity) included. `chip_smoke.py` holds each kernel to
  it bit for bit.

`engaged` is the one rule that picks `OPS` (`table`): the window on the
card, no parameter requiring grad, bf16 or float16 products.

While a profiler runs, every kernel launches inside a range of its own,
`tft_fused.launch` (`kernel/tracing.profiler_range`, a record like an
op's). Under `vmap` the dispatcher records each op twice, one record
inside the other, and the profiler's event tree drops the inner record
where it is the outer's only child (`EventList._remove_dup_nodes`). A
kernel launched straight from an op's body would link, in the device
trace, to the record the tree dropped, and a reader could not place it
under the forward's ranges; the launch's own range is kept, inside the op
and the stage around it.

`launches` counts the kernel launches made in this process; the pool and
the dedicated session count a dispatch as K3's
(`scoring.tft_fused_dispatches`) when it grew across their step.

`OPS.weights` rounds each weight to the compute dtype once per install,
not once a forward: the copy is cached on the weight tensor itself (held
weakly, so it goes with its tensor) and made again when the tensor's
version counter moved, as every install in the port moves it
(`TenantStack.set_params` and the sessions' swaps write with `copy_`). A
write through `.data` would not move it, and is not made. `PLAIN.weights`
rounds anew each forward, with no cache.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor
from torch.utils._pytree import tree_leaves

from sitewhere_tpu_torch.kernel.tracing import close_range, profiler_range

# kernel launches since import (or since a caller reset it to 0)
launches = 0

# compute dtype → the kernels' rounding kind
KINDS = {torch.bfloat16: 0, torch.float16: 1}
# ... and the plain versions', which take float32 products too (whose
# rounding is the identity)
ROUNDINGS = {**KINDS, torch.float32: 2}
_DTYPES = {v: k for k, v in ROUNDINGS.items()}

# which outputs an op writes: the float32 value, its rounded copy, or both
RAW, ROUNDED, BOTH = 1, 2, 3
# the weight leaves of the TFT's parameter tree (dense, LSTM input and
# recurrent weights); everything else is used as it is
WEIGHT_KEYS = ("w", "wx", "wh")
# the selection networks' inputs the kernel takes at most
MAX_VARS = 4


def on_card(device) -> bool:
    """Is `device` the card? The one test that sends an op to its kernel:
    each op asks it, not the dispatcher's device key, so that the tests
    can take CPU tensors for the card's and read each launch's arguments."""
    return torch.device(device).type == "cuda"


def engaged(params, x: Tensor, cdt) -> bool:
    """Does a TFT forward on `x` run `OPS`? Where the window is on the card,
    no parameter requires grad (training through `loss` runs `PLAIN`,
    which autograd differentiates) and the products round to bf16 or
    float16."""
    return (cdt in KINDS and on_card(x.device)
            and not any(t.requires_grad for t in tree_leaves(params)))


def _round(x: Tensor, kind: int) -> Tensor:
    return x.to(_DTYPES[kind]).float()


# -- the weights, rounded once a version --------------------------------------

# (id of the weight, kind) → (weakref to it, its version, the rounded copy)
_weights: dict = {}


def _rounded(w: Tensor, kind: int) -> Tensor:
    if w.is_inference():   # no version counter: nothing to key a copy on
        return _round(w, kind)
    key = (id(w), kind)
    hit = _weights.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    out = _round(w, kind)
    ref = weakref.ref(w, lambda _, key=key: _weights.pop(key, None))
    _weights[key] = (ref, w._version, out)
    return out


@torch.library.custom_op("swx::tft_weights", mutates_args=())
def weights(ws: List[Tensor], kind: int) -> List[Tensor]:
    """Each weight rounded to the compute dtype and back to float32, the
    copy cached on the weight tensor until its version moves."""
    return [_rounded(w, kind) for w in ws]


def _weights_vmap(info, in_dims, ws, kind):
    dims = in_dims[0]
    ws = [w if d in (None, 0) else w.movedim(d, 0) for w, d in zip(ws, dims)]
    return weights(ws, kind), [None if d is None else 0 for d in dims]


weights.register_vmap(_weights_vmap)


def weights_plain(ws: List[Tensor], kind: int) -> List[Tensor]:
    return [_round(w, kind) for w in ws]


def rounded_weights(ops, params: dict, kind: int) -> dict:
    """`params` with every weight leaf (`WEIGHT_KEYS`) rounded, through one
    `ops.weights` call; biases, norms and the static vector as they are."""
    found: list = []

    def collect(node):
        if isinstance(node, dict):
            for k, v in node.items():
                if k in WEIGHT_KEYS and isinstance(v, Tensor):
                    found.append(v)
                else:
                    collect(v)
        elif isinstance(node, list):
            for v in node:
                collect(v)

    collect(params)
    done = iter(ops.weights(found, kind))

    def rebuild(node):
        if isinstance(node, dict):
            return {k: (next(done) if k in WEIGHT_KEYS
                        and isinstance(v, Tensor) else rebuild(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        return node

    return rebuild(params)


# -- operands and launches ----------------------------------------------------


def _lead(tensors: list) -> list:
    """The leading dims that the operands (None skipped) broadcast to."""
    live = [t for t in tensors if t is not None]
    rank = max(t.dim() for t in live) - 1
    lead = [1] * rank
    for t in live:
        for i, n in enumerate(t.shape[:-1], rank - t.dim() + 1):
            if n != 1:
                if lead[i] not in (1, n):
                    raise ValueError(f"operand {list(t.shape)} does not "
                                     f"broadcast over rows {lead}")
                lead[i] = n
    return lead


def _plan(tensors: list) -> tuple[tuple, list]:
    """The call's row space and each operand's strides in it: every
    operand `[..., columns]` broadcasts over the common leading dims,
    which are merged where every operand allows and padded to three; an
    operand of one column is a row's scalar (sc 0). Returns ((R0, R1, R2),
    [(s0, s1, s2, sc) or None])."""
    lead = _lead(tensors)
    rank = len(lead)
    keep = [i for i, n in enumerate(lead) if n != 1]
    sizes = [lead[i] for i in keep]
    rows = []
    for t in tensors:
        if t is None:
            rows.append(None)
            continue
        pad = rank - t.dim() + 1
        shape = (1,) * pad + tuple(t.shape[:-1])
        stride = (0,) * pad + t.stride()[:-1]
        rows.append([stride[i] if shape[i] != 1 else 0 for i in keep])
    i = len(sizes) - 2
    while i >= 0:
        if all(r is None or r[i] == r[i + 1] * sizes[i + 1] for r in rows):
            sizes[i + 1] *= sizes[i]
            del sizes[i]
            for r in rows:
                if r is not None:
                    del r[i]
        i -= 1
    if len(sizes) > 3:
        raise ValueError(f"operands of leading shape {lead} need "
                         f"{len(sizes)} row dimensions; the kernels take 3")
    pad = 3 - len(sizes)
    dims = (1,) * pad + tuple(sizes)
    out = [None if r is None else
           (*((0,) * pad), *r, t.stride()[-1] if t.shape[-1] != 1 else 0)
           for r, t in zip(rows, tensors)]
    return dims, out


def _c_entry(name: str):
    from sitewhere_tpu_torch.ops.build import library

    fn = getattr(library("tft_fused"), f"swx_tft_{name}")
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _width(operands: list, strides: list, n: int, scalar=()) -> int:
    """4 where a thread may take four columns at once, one 16-byte access
    an operand: every row of every operand but the `scalar` ones (read an
    element at a time) starts 16-byte aligned and its columns are
    contiguous or a row's scalar; else 1."""
    if n % 4:
        return 1
    for i, (t, s) in enumerate(zip(operands, strides)):
        if t is None or i in scalar or s[3] == 0:
            continue
        if s[3] != 1 or t.data_ptr() % 16 or any(x % 4 for x in s[:3]):
            return 1
    return 4


def _launch(name: str, operands: list, n: int, kind: int, aux=(0, 0),
            f: float = 0.0, scalar=(), vector: bool = True) -> None:
    """Launch `swx_tft_<name>` over `operands` (tensors, or None for an
    operand the call leaves out), rows of `n` columns; the `scalar`
    operands are read an element at a time, and a kernel whose columns
    may not be taken four at a time says so (`vector`)."""
    live = [t for t in operands if t is not None]
    device = live[0].device
    for t in live:
        if t.device != device:
            raise ValueError(f"operand on {t.device}, the first on {device}")
        if t.dtype not in (torch.float32, torch.bool):
            raise ValueError(f"operands are float32 (or a bool mask), not "
                             f"{t.dtype}")
    if not on_card(device):
        raise ValueError(f"the CUDA kernels take tensors on the card, not "
                         f"on {device}")
    dims, strides = _plan(operands)
    width = _width(operands, strides, n, scalar) if vector else 1
    desc = []
    for t, s in zip(operands, strides):
        desc += [0, 0, 0, 0, 0] if t is None else [t.data_ptr(), *s]
    with torch.cuda.device(device):
        _call(name, _c_entry(name), desc,
              (ctypes.c_longlong * 7)(*dims, n, *aux, width), f, kind,
              _stream(device))


# the range around each launch while a profiler runs (see the module's doc)
LAUNCH_RANGE = "tft_fused.launch"


def _call(name: str, fn, desc: list, c_dims, f: float, kind: int,
          stream: int) -> None:
    """The C entry `fn` (`swx_tft_<name>`) over the operand descriptors
    `desc`, five an operand (address, three row strides, the column
    stride), and the call's `c_dims`."""
    global launches
    rf = profiler_range(LAUNCH_RANGE)
    try:
        err = fn((ctypes.c_longlong * len(desc))(*desc), len(desc) // 5,
                 c_dims, f, kind, stream)
    finally:
        close_range(rf)
    if err != 0:
        raise RuntimeError(f"tft_fused {name} kernel launch failed: "
                           f"cudaError {err}")
    launches += 1


def _out(lead_of: list, cols: int, like: Tensor) -> Tensor:
    """A float32 output of `cols` columns over the operands' rows."""
    return torch.empty((*_lead(lead_of), cols), dtype=torch.float32,
                       device=like.device)


def _dense_layout(x: Tensor) -> bool:
    """Do `x`'s elements fill its span with no gap or overlap, in some
    order of its dims (what `empty_like` keeps)?"""
    dims = sorted((s, n) for s, n in zip(x.stride(), x.shape) if n != 1)
    expect = 1
    for s, n in dims:
        if s != expect:
            return False
        expect *= n
    return True


def _pick(outs: int, raw: Tensor, rounded: Tensor) -> List[Tensor]:
    return [t for t, bit in ((raw, RAW), (rounded, ROUNDED)) if outs & bit]


# -- vmap: the tenant axis as the leading row dimension -----------------------


def _rowwise_vmap(op):
    """A `vmap` rule for an op over row operands: each tensor's batch dim
    moves to the front (an unbatched one gets a leading 1), and singleton
    dims after it pad every operand to the same leading rank, so that the
    operands broadcast per tenant as they did per call."""

    def rule(info, in_dims, *args):
        tensors = []
        for a, d in zip(args, in_dims):
            if isinstance(a, Tensor):
                tensors.append((a, d))
            elif isinstance(a, (list, tuple)):
                tensors += [(t, e) for t, e in zip(a, d or [None] * len(a))]
        lead = max(t.dim() - (d is not None) - 1 for t, d in tensors)

        def lift(t, d):
            t = t.movedim(d, 0) if d is not None else t.unsqueeze(0)
            pad = lead - (t.dim() - 2)
            return t[(slice(None),) + (None,) * pad] if pad else t

        lifted = []
        for a, d in zip(args, in_dims):
            if isinstance(a, Tensor):
                lifted.append(lift(a, d))
            elif isinstance(a, (list, tuple)):
                lifted.append([lift(t, e) for t, e in
                               zip(a, d or [None] * len(a))])
            else:
                lifted.append(a)
        out = op(*lifted)
        return out, [0] * len(out)

    return rule


# -- the ops: each a plain version and the kernel ----------------------------


def round_plain(x: Tensor, kind: int) -> List[Tensor]:
    return [_round(x, kind)]


@torch.library.custom_op("swx::tft_round", mutates_args=())
def round_(x: Tensor, kind: int) -> List[Tensor]:
    """`x` rounded to the compute dtype and back, in `x`'s layout where it
    is dense (as `.to()` keeps it), else contiguous."""
    if not on_card(x.device):
        return round_plain(x, kind)
    if not _dense_layout(x):
        x = x.contiguous()
    out = torch.empty_like(x)
    # the elements in memory order, as rows of up to 32
    n, cols = x.numel(), 32
    while n % cols:
        cols //= 2
    flat = ((n // cols, cols), (cols, 1))
    _launch("round", [out.as_strided(*flat), x.as_strided(*flat)], cols,
            kind)
    return [out]


def dense_plain(mm, b, mm2, b2, elu, outs, kind) -> List[Tensor]:
    y = _round(mm, kind) + b
    if mm2 is not None:
        y = y + (_round(mm2, kind) + b2)
    if elu:
        y = F.elu(y)
    return _pick(outs, y, _round(y, kind) if outs & ROUNDED else None)


@torch.library.custom_op("swx::tft_dense", mutates_args=())
def dense(mm: Tensor, b: Tensor, mm2: Optional[Tensor], b2: Optional[Tensor],
          elu: bool, outs: int, kind: int) -> List[Tensor]:
    """A dense layer's epilogue on its float32 product `mm`:
    y = rdt(mm) + b, plus (rdt(mm2) + b2) where a context product is given,
    then ELU where asked; returns y and/or rdt(y) (`outs`)."""
    if not on_card(mm.device):
        return dense_plain(mm, b, mm2, b2, elu, outs, kind)
    n = mm.shape[-1]
    raw = _out([mm, b, mm2, b2], n, mm) if outs & RAW else None
    rd = _out([mm, b, mm2, b2], n, mm) if outs & ROUNDED else None
    _launch("dense", [raw, rd, mm, b, mm2, b2], n, kind, aux=(int(elu), 0))
    return [t for t in (raw, rd) if t is not None]


def gate_plain(mm, b, skip, skip_b, kind) -> List[Tensor]:
    val, gt = (_round(mm, kind) + b).chunk(2, dim=-1)
    glu = val * torch.sigmoid(gt)
    s = _round(skip, kind) + skip_b if skip_b is not None else skip
    return [s + glu]


@torch.library.custom_op("swx::tft_gate", mutates_args=())
def gate(mm: Tensor, b: Tensor, skip: Tensor, skip_b: Optional[Tensor],
         kind: int) -> List[Tensor]:
    """The gated skip before its LayerNorm: g = rdt(mm) + b, its halves the
    value and the gate; returns skip + value·σ(gate), the skip rounded and
    biased by `skip_b` where it is the skip layer's product."""
    if not on_card(mm.device):
        return gate_plain(mm, b, skip, skip_b, kind)
    n = mm.shape[-1] // 2
    out = _out([mm, b, skip, skip_b], n, mm)
    _launch("gate", [out, mm, b, skip, skip_b], n, kind)
    return [out]


def sqdev_plain(x, mu, kind) -> List[Tensor]:
    return [(x - mu) ** 2]


@torch.library.custom_op("swx::tft_sqdev", mutates_args=())
def sqdev(x: Tensor, mu: Tensor, kind: int) -> List[Tensor]:
    """LayerNorm's centred square (x − mu)², for torch's second mean."""
    if not on_card(x.device):
        return sqdev_plain(x, mu, kind)
    out = _out([x, mu], x.shape[-1], x)
    _launch("sqdev", [out, x, mu], x.shape[-1], kind)
    return [out]


def ln_plain(x, mu, var, scale, bias, outs, kind) -> List[Tensor]:
    y = (x - mu) * torch.rsqrt(var + 1e-6) * scale + bias
    return _pick(outs, y, _round(y, kind) if outs & ROUNDED else None)


@torch.library.custom_op("swx::tft_ln", mutates_args=())
def ln(x: Tensor, mu: Tensor, var: Tensor, scale: Tensor, bias: Tensor,
       outs: int, kind: int) -> List[Tensor]:
    """LayerNorm's apply given torch's means: y and/or rdt(y) (`outs`)."""
    if not on_card(x.device):
        return ln_plain(x, mu, var, scale, bias, outs, kind)
    n = x.shape[-1]
    ops = [x, mu, var, scale, bias]
    raw = _out(ops, n, x) if outs & RAW else None
    rd = _out(ops, n, x) if outs & ROUNDED else None
    _launch("ln", [raw, rd, *ops], n, kind)
    return [t for t in (raw, rd) if t is not None]


def vsn_plain(xs, mus, variances, scales, biases, w, kind) -> List[Tensor]:
    ys = [(x - m) * torch.rsqrt(v + 1e-6) * s + b
          for x, m, v, s, b in zip(xs, mus, variances, scales, biases)]
    out = (torch.stack(ys, dim=-2) * w[..., None]).sum(dim=-2)
    return [out, _round(out, kind)]


@torch.library.custom_op("swx::tft_vsn", mutates_args=())
def vsn(xs: List[Tensor], mus: List[Tensor], variances: List[Tensor],
        scales: List[Tensor], biases: List[Tensor], w: Tensor,
        kind: int) -> List[Tensor]:
    """A variable selection's end: each input's GRN LayerNorm applied,
    weighed by its column of `w` and summed over the inputs; returns the
    sum and its rounded copy."""
    if not on_card(w.device):
        return vsn_plain(xs, mus, variances, scales, biases, w, kind)
    nv, n = len(xs), xs[0].shape[-1]
    if not 1 <= nv <= MAX_VARS:
        raise ValueError(f"{nv} selection inputs; the kernel takes 1 to "
                         f"{MAX_VARS}")
    per = [t for group in zip(xs, mus, variances, scales, biases)
           for t in group]
    raw, rd = _out([w, *per], n, w), _out([w, *per], n, w)
    _launch("vsn", [raw, rd, w, *per], n, kind, aux=(nv, 0), scalar=(2,))
    return [raw, rd]


def cell_plain(xw, mm, b, c, kind) -> List[Tensor]:
    d = c.shape[-1]
    gates = _round(xw, kind) + _round(mm, kind) + b
    act = torch.sigmoid(gates)             # i, f and o; g's unused
    c2 = act[..., d:2 * d] * c + act[..., :d] * torch.tanh(
        gates[..., 2 * d:3 * d])
    h = act[..., 3 * d:] * torch.tanh(c2)
    return [c2, _round(h, kind)]


def lstm_plain(xw, wh, b, h0, c0, kind) -> List[Tensor]:
    rows, steps, d = xw.shape[:-2], xw.shape[-2], wh.shape[-2]
    zeros = torch.zeros((*rows, d), dtype=torch.float32, device=xw.device)
    h = h0 if h0 is not None else zeros
    c = c0 if c0 is not None else zeros
    hs = []
    for t in range(steps):
        c, h = cell_plain(xw[..., t, :], h @ wh, b, c, kind)
        hs.append(h)
    out = torch.stack(hs, dim=-2) if hs else xw.new_zeros((*rows, 0, d))
    return [out, h, c]


@torch.library.custom_op("swx::tft_lstm", mutates_args=())
def lstm(xw: Tensor, wh: Tensor, b: Tensor, h0: Optional[Tensor],
         c0: Optional[Tensor], kind: int) -> List[Tensor]:
    """The LSTM over `xw` [..., T, 4d], the input's products for every
    step, unrounded, from (h0, c0) (zeros where None; h0 rounded): a step
    is the product h·wh (cuBLAS, as the plain version) and one cell launch.
    Returns (rdt(h) at every step [..., T, d], the last rdt(h), the last
    c)."""
    if not on_card(xw.device):
        return lstm_plain(xw, wh, b, h0, c0, kind)
    rows, steps, d = xw.shape[:-2], xw.shape[-2], wh.shape[-2]
    dev = xw.device
    zeros = torch.zeros((*rows, d), dtype=torch.float32, device=dev)
    h = h0 if h0 is not None else zeros
    c = (c0.expand(*rows, d).contiguous() if c0 is not None else zeros)
    hs = torch.empty((*rows, steps, d), dtype=torch.float32, device=dev)
    if not steps:
        return [hs, h, c]
    # every step's operands have the first step's layout: check and plan
    # the launch once, then hand the kernel each step's pointers
    mm = h @ wh
    c2, hr = torch.empty_like(c), torch.empty_like(c)
    first = [c2, hr, xw[..., 0, :], mm, b, c, hs[..., 0, :]]
    for t in first:
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"LSTM operands are float32 on {dev}, not "
                             f"{t.dtype} on {t.device}")
    dims, strides = _plan(first)
    # a step's slot and input product move by whole rows of 4d and d floats
    width = _width(first, strides, d) if d % 4 == 0 else 1
    fn = _c_entry("cell")
    c_dims = (ctypes.c_longlong * 7)(*dims, d, 0, 0, width)
    step_xw = xw.stride(-2) * xw.element_size()
    step_hs = hs.stride(-2) * hs.element_size()
    xw0, hs0 = xw.data_ptr(), hs.data_ptr()
    with torch.cuda.device(dev):
        stream = _stream(dev)
        for t in range(steps):
            if t:
                mm = h @ wh
                c2, hr = torch.empty_like(c), torch.empty_like(c)
            ptrs = (c2.data_ptr(), hr.data_ptr(), xw0 + t * step_xw,
                    mm.data_ptr(), b.data_ptr(), c.data_ptr(),
                    hs0 + t * step_hs)
            desc = [v for p, s in zip(ptrs, strides) for v in (p, *s)]
            _call("cell", fn, desc, c_dims, 0.0, kind, stream)
            c, h = c2, hr
    return [hs, h, c]


def _lstm_vmap(info, in_dims, xw, wh, b, h0, c0, kind):
    """The tenant axis to the front of every operand; the bias over the
    rows of its tenant."""
    def front(t, d):
        if t is None:
            return None
        return t.movedim(d, 0) if d is not None else t.unsqueeze(0)

    xd, whd, bd, hd, cd = in_dims[:5]
    out = lstm(front(xw, xd), front(wh, whd), front(b, bd).unsqueeze(1),
               front(h0, hd), front(c0, cd), kind)
    return out, [0, 0, 0]


lstm.register_vmap(_lstm_vmap)


def embed_plain(f, ws, bs, kind) -> List[Tensor]:
    nv, d = len(ws), ws[0].shape[-1]
    raw = torch.stack([_round(_round(f[..., i:i + 1], kind) @ w, kind) + b
                       for i, (w, b) in enumerate(zip(ws, bs))], dim=-2)
    flat = _round(raw.reshape(*raw.shape[:-2], nv * d), kind)
    return [raw, flat, *(_round(raw[..., i, :], kind) for i in range(nv))]


@torch.library.custom_op("swx::tft_embed", mutates_args=())
def embed(f: Tensor, ws: List[Tensor], bs: List[Tensor],
          kind: int) -> List[Tensor]:
    """Each input's embedding, the K = 1 product rdt(f_v)·w_v rounded plus
    b_v: returns the embeddings stacked `[..., nv, d]`, their rounded copy
    flattened `[..., nv·d]` and each input's rounded `[..., d]`; `ws` the
    rounded `[1, d]` weights."""
    if not on_card(f.device):
        return embed_plain(f, ws, bs, kind)
    nv, d = len(ws), ws[0].shape[-1]
    if not 1 <= nv <= MAX_VARS:
        raise ValueError(f"{nv} embedded inputs; the kernel takes 1 to "
                         f"{MAX_VARS}")
    w = torch.cat(ws, dim=-1)
    b = torch.cat(bs, dim=-1)
    flat = _out([f, w, b], nv * d, f)
    rflat = torch.empty_like(flat)
    each = [_out([f, w, b], d, f) for _ in range(nv)]
    _launch("embed", [flat, rflat, f, w, b, *each], nv * d, kind,
            aux=(d, nv), scalar=(2,), vector=d % 4 == 0)
    return [flat.view(*flat.shape[:-1], nv, d), rflat, *each]


def logits_plain(e, valid, context, scale, kind) -> List[Tensor]:
    h, w = e.shape[-2], e.shape[-1]
    key = torch.arange(w, device=e.device)
    query = torch.arange(h, device=e.device)
    causal = key[None, :] <= (context + query)[:, None]
    ok = torch.cat([valid[..., :context].bool(),
                    torch.ones((*valid.shape[:-1], w - context),
                               dtype=torch.bool, device=e.device)], dim=-1)
    out = _round(e, kind) / scale
    return [out.masked_fill(~(causal & ok), -1e9)]


@torch.library.custom_op("swx::tft_logits", mutates_args=())
def logits(e: Tensor, valid: Tensor, context: int, scale: float,
           kind: int) -> List[Tensor]:
    """The attention's logits from the score product `e` [..., H, W]:
    rdt(e) / scale where horizon query q may see key k (k ≤ context + q,
    and a context key's reading valid), else −1e9; `valid` [..., 1, W]
    broadcasts over the queries (and the heads before them)."""
    if not on_card(e.device):
        return logits_plain(e, valid, context, scale, kind)
    h, w = e.shape[-2], e.shape[-1]
    out = _out([e, valid], w, e)
    # rows (..., head, query), the query fastest: the kernel reads q = i2 % H;
    # torch divides by a Python scalar as a multiply by its float32 reciprocal
    inv = float(np.float32(1.0) / np.float32(scale))
    _launch("logits", [out, e, valid.bool()], w, kind, aux=(h, context),
            f=inv, scalar=(2,))
    return [out]


class Table(NamedTuple):
    """The TFT forward's ops by name, one signature an entry in both tables:
    each kernel's op by the name of its entry, and the weights' rounding."""
    weights: Callable
    round: Callable
    dense: Callable
    gate: Callable
    sqdev: Callable
    ln: Callable
    vsn: Callable
    lstm: Callable
    embed: Callable
    logits: Callable


OPS = Table(weights, round_, dense, gate, sqdev, ln, vsn, lstm, embed, logits)
PLAIN = Table(weights_plain, round_plain, dense_plain, gate_plain,
              sqdev_plain, ln_plain, vsn_plain, lstm_plain, embed_plain,
              logits_plain)
# the entries that launch a kernel on the card
KERNELS = Table._fields[1:]


def table(params, x: Tensor, cdt) -> Table:
    """The op table a TFT forward on `x` runs: `OPS` where `engaged`."""
    return OPS if engaged(params, x, cdt) else PLAIN


for _name in KERNELS:
    if _name != "lstm":
        _op = getattr(OPS, _name)
        _op.register_vmap(_rowwise_vmap(_op))
