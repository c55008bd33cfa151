"""Build and load the port's native libraries.

Each CUDA source under `sitewhere_tpu_torch/csrc/` is compiled by `nvcc`
for `sm_90a` into a shared library with a plain C interface, loaded with
`ctypes` (no PyTorch headers, so a build takes seconds). The host
library of the telemetry store (`csrc/swx_native.cpp`, C++ for the CPU)
is compiled the same way by `g++ -O3 -shared -fPIC`. Builds happen at
first use, from the repository's sources alone, into
`build/torch_kernels/<name>-<hash>/` beside the package; the hash covers
the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. The compiler writes to a temporary file that
`os.replace` moves into place, so concurrent builds (test workers,
threads) never load a half-written library. A failed build raises.
`build_all()` starts one compiler per source, all together, and waits
for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"

# name → source file; every kernel the port launches is listed here
SOURCES = {"lstm_window": "lstm_window.cu",
           "lstm_stream_step": "lstm_stream_step.cu",
           "tft_fused": "tft_fused.cu"}
# host libraries (C++ for the CPU, built with g++): name → source file
HOST_SOURCES = {"swx_native": "swx_native.cpp"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no -march=native: a library built on one host may be loaded on
# another sharing the checkout, and an ISA mismatch is a SIGILL
GXX_FLAGS = ["-O3", "-shared", "-fPIC"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the telemetry store's native "
                       "library cannot be built")


def _source_and_flags(name: str) -> tuple[str, list]:
    if name in HOST_SOURCES:
        return HOST_SOURCES[name], GXX_FLAGS
    return SOURCES[name], NVCC_FLAGS


def _target(name: str) -> Path:
    source, flags = _source_and_flags(name)
    src = (CSRC / source).read_bytes()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _start(name: str):
    """Start the compiler for one source unless its library exists;
    returns (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".so.tmp{os.getpid()}.{threading.get_ident()}")
    source, flags = _source_and_flags(name)
    compiler = gxx_path() if name in HOST_SOURCES else nvcc_path()
    cmd = [compiler, *flags, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(proc.args[0]).name} failed for "
                           f"{_source_and_flags(name)[0]}:\n{out}")
    os.replace(tmp, target)  # atomic: a reader never sees a partial file
    (target.parent / "build.log").write_text(out)
    return out


def build_all() -> dict[str, str]:
    """Compile every CUDA and host source in parallel; returns name →
    compiler output (`-Xptxas -v` register/shared-memory report for a
    kernel; empty when the library was already built)."""
    names = [*SOURCES, *HOST_SOURCES]
    jobs = {name: _start(name) for name in names}
    return {name: _finish(name, *jobs[name]) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it on first use."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                target, job = _start(name)
                _finish(name, target, job)
                lib = _libs[name] = ctypes.CDLL(str(target))
    return lib
