"""Fused windowed-LSTM recurrence → final hidden, as a Hopper kernel.

Replaces the Pallas TPU kernel `_pallas_final` (sitewhere_tpu/ops/
lstm_kernel.py:67-96, pallas_call at :75). The windowed scorer re-runs a
W-step LSTM over every flushed device window but consumes only the LAST
step's prediction, so the kernel keeps h/c and both weight matrices on
chip for all T = W-1 steps and writes back only the final h `[B, h]`.
The CUDA source is `csrc/lstm_window.cu`; its header states the design
and the bound (≈34 GFLOP per B=16384 flush: operations, not bytes, bound
it; ≈35 µs at the bf16 dense rate).

`lstm_window_final` launches the kernel for a CUDA tensor and uses the
plain PyTorch version below only for a CPU tensor. There is no fallback:
a CUDA call that the kernel does not take, or that fails to build or
launch, raises. `launches` counts kernel launches (never plain calls).

Semantics match the Pallas kernel: x_t and h rounded to bf16 as matmul
operands, bf16 weights, f32 accumulation, f32 bias, gates and state.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches since import (or since a caller reset it to 0)
launches = 0

KERNEL_HIDDEN = (32, 64)   # hidden widths the CUDA kernel is built for


def lstm_window_final_plain(wx: torch.Tensor, wh: torch.Tensor,
                            b: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: a Python loop over T with
    bf16-rounded operands and float32 products and sums."""
    B, T = xn.shape
    hidden = wh.shape[0]
    wx = wx.reshape(1, -1).bfloat16().float()
    wh = wh.bfloat16().float()
    b = b.reshape(1, -1).float()
    h = torch.zeros((B, hidden), dtype=torch.float32, device=xn.device)
    c = torch.zeros_like(h)
    for t in range(T):
        x = xn[:, t:t + 1].bfloat16().float()
        gates = x @ wx + h.bfloat16().float() @ wh + b
        i, f, g, o = gates.split(hidden, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
    return h


def _check(params_layer: dict, xn: torch.Tensor, cdt) -> tuple:
    if cdt != torch.bfloat16:
        raise ValueError(f"the fused window kernel computes in bfloat16, "
                         f"not {cdt}")
    wx, wh, b = params_layer["wx"], params_layer["wh"], params_layer["b"]
    if xn.dim() != 2 or xn.dtype != torch.float32:
        raise ValueError(f"xn must be [B, T] float32, got "
                         f"{tuple(xn.shape)} {xn.dtype}")
    if xn.shape[1] < 1 or xn.stride(1) != 1 or xn.stride(0) < xn.shape[1]:
        raise ValueError("xn needs T >= 1, unit stride along T and rows "
                         "that do not overlap")
    hidden = wh.shape[0]
    if (wh.dim() != 2 or tuple(wh.shape) != (hidden, 4 * hidden)
            or wx.numel() != 4 * hidden or tuple(wx.shape)[-1] != 4 * hidden
            or b.numel() != 4 * hidden):
        raise ValueError(
            f"single-layer scalar-input LSTM params expected: wx [1, 4h], "
            f"wh [h, 4h], b [4h]; got {tuple(wx.shape)}, {tuple(wh.shape)}, "
            f"{tuple(b.shape)}")
    for name, p in (("wx", wx), ("wh", wh), ("b", b)):
        if p.device != xn.device:
            raise ValueError(f"{name} is on {p.device}, xn on {xn.device}")
    return wx, wh, b


def _c_entry():
    from sitewhere_tpu_torch.ops.build import library

    fn = library("lstm_window").swx_lstm_window_final
    if fn.argtypes is None:  # pointers must not pass as 32-bit ints
        fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _launch(wx: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
            xn: torch.Tensor) -> torch.Tensor:
    global launches
    B, T = xn.shape
    hidden = wh.shape[0]
    if hidden not in KERNEL_HIDDEN:
        raise ValueError(f"the CUDA kernel is built for hidden in "
                         f"{KERNEL_HIDDEN}, not {hidden}")
    fn = _c_entry()
    # the bf16 copies are freed when this returns; the caching allocator
    # hands their memory only to work queued after the kernel on this
    # stream, so the asynchronous launch never reads a reused buffer
    wx16 = wx.reshape(-1).to(torch.bfloat16).contiguous()
    wh16 = wh.to(torch.bfloat16).contiguous()
    b32 = b.reshape(-1).float().contiguous()
    out = torch.empty((B, hidden), dtype=torch.float32, device=xn.device)
    with torch.cuda.device(xn.device):
        stream = torch.cuda.current_stream(xn.device).cuda_stream
        err = fn(xn.data_ptr(), xn.stride(0), wx16.data_ptr(),
                 wh16.data_ptr(), b32.data_ptr(), out.data_ptr(),
                 B, T, hidden, stream)
    if err != 0:
        raise RuntimeError(f"lstm_window_final kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return out


def lstm_window_final(params_layer: dict, xn: torch.Tensor,
                      cdt) -> torch.Tensor:
    """Final hidden state `[B, h]` float32 of a single-layer LSTM over
    xn `[B, T]` float32 (the caller already dropped the last window slot;
    a row-strided view is taken as it is). CUDA tensor → the kernel;
    CPU tensor → the plain version; anything else raises."""
    wx, wh, b = _check(params_layer, xn, cdt)
    if xn.device.type == "cuda":
        return _launch(wx, wh, b, xn)
    if xn.device.type == "cpu":
        return lstm_window_final_plain(wx, wh, b, xn)
    raise ValueError(f"no lstm_window_final for device {xn.device}")
