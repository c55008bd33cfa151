"""ctypes bridge to the telemetry store's host library
(`csrc/swx_native.cpp`).

`get_lib()` loads `libswx_native.so`, building it with g++ at first use
into the checkout's `build/` directory (ops/build.py: keyed on a hash of
the source and flags, written to a temporary file and moved into place,
so concurrent test workers never load a half-written library). There is
no fallback: a missing compiler or a failed build or load raises. The
store's numpy functions (persistence/telemetry.py `*_plain`) are the
library's plain versions, for the tests and the chip check only.

ctypes releases the GIL during calls, so appends from several service
threads run in parallel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i64 = ctypes.c_int64


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.swx_telemetry_append.restype = _i64
    lib.swx_telemetry_append.argtypes = [
        _f32p, _f64p, _i64p, _i64p, _i64, _i64, _u32p, _f32p, _f64p, _i64]
    lib.swx_window_gather.restype = None
    lib.swx_window_gather.argtypes = [
        _f32p, _i64p, _i64p, _i64, _u32p, _i64, _i64, _f32p, _u8p]
    lib.swx_window_ts_gather.restype = None
    lib.swx_window_ts_gather.argtypes = [
        _f64p, _i64p, _i64, _u32p, _i64, _i64, _f64p]
    lib.swx_latest.restype = None
    lib.swx_latest.argtypes = [
        _f32p, _f64p, _i64p, _i64, _u32p, _i64, _f32p, _f64p]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built on first use; raises if it cannot
    be built or loaded."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                from sitewhere_tpu_torch.ops.build import library

                _lib = _bind(library("swx_native"))
    return _lib
