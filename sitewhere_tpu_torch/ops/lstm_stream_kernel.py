"""The streaming-LSTM step as one Hopper kernel (K2).

Replaces no Pallas kernel: the JAX package leaves the streaming step
(`scoring/stream.py`'s gather → `step_score` → scatter) to XLA. In the
port that step in PyTorch is a chain of about 60 small launches under
`torch.func.vmap`, which costs the event loop 3–4 ms a dispatch whatever
its size while the card works microseconds; K2 runs the whole step in one
launch on the ring's state in place (`csrc/lstm_stream_step.cu`, whose
header states the design and the bound: bytes, ≈5 µs for a 16,384-column
dispatch on an H100).

`lstm_stream_step` launches the kernel; it takes tensors on the card only.
Which rings take it is decided once, when a ring is built
(`scoring/stream.py`'s `streaming_step`), by `takes_kernel` from the
model's configuration and the ring's device; every other ring runs the
plain chain and never calls this module. There is no fallback: a call the
kernel does not take, or that fails to build or launch, raises.
`launches` counts the launches made in this process; the pool and the
dedicated session count a dispatch as K2's
(`scoring.stream_kernel_dispatches`) when it grew across their step.

Layout: a dispatch is `dev`/`v` `[T, B]` (int32 device ids, float32
readings; `[B]` for a dedicated ring, T = 1); state leaves are
`[T, rows, ...]` (`[rows, ...]` for a dedicated ring), tenant t's device d
at row d of tenant t; params are the model's single-layer tree stacked on
a leading tenant axis (unstacked for a dedicated ring). The scores come
back `[T, B]` (`[B]`) in `out_dtype` (float32 when None).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sitewhere_tpu_torch.ops.lstm_kernel import KERNEL_HIDDEN

# kernel launches since import (or since a caller reset it to 0)
launches = 0

SCORE_KINDS = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
STATE_LEAVES = ("pred", "mean", "var", "count", "h0", "c0")


def on_card(device) -> bool:
    """Is `device` the card? The one test of where the state lies that
    routes a step to K2."""
    return torch.device(device).type == "cuda"


def takes_kernel(model, device) -> bool:
    """Does a streaming ring of `model` on `device` step through K2? The
    model's configuration decides (`fused`: single layer, bf16, a hidden
    width the kernel is built for), with the state on the card."""
    return bool(model.fused) and on_card(device)


def check(params: dict, state: dict, dev: torch.Tensor,
          v: torch.Tensor, out_dtype) -> tuple:
    """Validate one call's inputs; returns (T, B, rows, hidden) or raises
    ValueError naming what the kernel does not take."""
    if set(state) != set(STATE_LEAVES):
        raise ValueError(f"state leaves {sorted(state)} are not a "
                         f"single-layer LSTM's {sorted(STATE_LEAVES)}")
    stacked = dev.dim() == 2
    if dev.dim() not in (1, 2) or tuple(v.shape) != tuple(dev.shape):
        raise ValueError(f"dev and v must be [B] or [T, B] alike, got "
                         f"{tuple(dev.shape)} and {tuple(v.shape)}")
    if dev.dtype != torch.int32 or v.dtype != torch.float32:
        raise ValueError(f"dev must be int32 and v float32, got {dev.dtype} "
                         f"and {v.dtype}")
    if not (dev.is_contiguous() and v.is_contiguous()):
        raise ValueError("dev and v must be contiguous")
    t = dev.shape[0] if stacked else 1
    b = dev.shape[-1]
    lead = (t,) if stacked else ()
    h = state["h0"]
    if h.dim() != len(lead) + 2:
        raise ValueError(f"state h0 {tuple(h.shape)} does not match a "
                         f"{tuple(dev.shape)} dispatch")
    rows, hidden = h.shape[-2], h.shape[-1]
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel is built for hidden in "
                         f"{KERNEL_HIDDEN}, not {hidden}")
    leaves = {"pred": ((*lead, rows), torch.float32),
              "mean": ((*lead, rows), torch.float32),
              "var": ((*lead, rows), torch.float32),
              "count": ((*lead, rows), torch.int32),
              "h0": ((*lead, rows, hidden), torch.float32),
              "c0": ((*lead, rows, hidden), torch.float32)}
    g = 4 * hidden
    lstm, head = params["lstm0"], params["head"]
    shapes = {"lstm0.wx": (lstm["wx"], (*lead, 1, g)),
              "lstm0.wh": (lstm["wh"], (*lead, hidden, g)),
              "lstm0.b": (lstm["b"], (*lead, g)),
              "head.w": (head["w"], (*lead, hidden, 1)),
              "head.b": (head["b"], (*lead, 1))}
    tensors = [(k, state[k], shape, dtype)
               for k, (shape, dtype) in leaves.items()]
    tensors += [(k, p, shape, torch.float32)
                for k, (p, shape) in shapes.items()]
    for name, x, shape, dtype in tensors:
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {list(shape)} {dtype}, got "
                             f"{list(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev.device:
            raise ValueError(f"{name} is on {x.device}, dev on {dev.device}")
    if v.device != dev.device:
        raise ValueError(f"v is on {v.device}, dev on {dev.device}")
    if out_dtype is not None and out_dtype not in SCORE_KINDS:
        raise ValueError(f"scores in {out_dtype}: the kernel writes "
                         f"{list(SCORE_KINDS)}")
    return t, b, rows, hidden


def _c_entry():
    from sitewhere_tpu_torch.ops.build import library

    fn = library("lstm_stream_step").swx_lstm_stream_step
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [ptr, ptr, i32, i32,                # dev, v, T, B
                       ptr, ptr, ptr, ptr, ptr, ptr,      # state leaves
                       ctypes.c_long,                     # rows a tenant
                       ptr, ptr, ptr, ptr, ptr,           # params
                       ptr, i32, i32, i32, i32,           # scores, kind, H, W, min
                       ctypes.c_float, ptr]               # clip, stream
        fn.restype = ctypes.c_int
    return fn


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lstm_stream_step(params: dict, state: dict, dev: torch.Tensor,
                     v: torch.Tensor, *, window: int, min_count: int,
                     score_clip: float,
                     out_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Score and advance one event a dispatch column, in place on `state`,
    in one launch of the kernel; tensors anywhere but on the card raise."""
    global launches
    t, b, rows, hidden = check(params, state, dev, v, out_dtype)
    if not on_card(dev.device):
        raise ValueError(f"the CUDA kernel takes tensors on the card, not "
                         f"on {dev.device}")
    out = torch.empty(dev.shape, dtype=out_dtype or torch.float32,
                      device=dev.device)
    lstm, head = params["lstm0"], params["head"]
    fn = _c_entry()
    with torch.cuda.device(dev.device):
        err = fn(dev.data_ptr(), v.data_ptr(), t, b,
                 *(state[k].data_ptr() for k in STATE_LEAVES), rows,
                 lstm["wx"].data_ptr(), lstm["wh"].data_ptr(),
                 lstm["b"].data_ptr(), head["w"].data_ptr(),
                 head["b"].data_ptr(), out.data_ptr(),
                 SCORE_KINDS[out.dtype], hidden, window, min_count,
                 score_clip, _stream(dev.device))
    if err != 0:
        raise RuntimeError(f"lstm_stream_step kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out
