"""Build and load the port's CUDA kernels.

Each source under `sitewhere_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into a shared library with a plain C interface, loaded with
`ctypes` (no PyTorch headers, so a build takes seconds). Builds happen
at first use, from the repository's sources alone, into
`build/torch_kernels/<name>-<hash>/` beside the package; the hash covers
the source and the flags, so an edited kernel is rebuilt and a stale
library is never loaded. `build_all()` starts one `nvcc` per source, all
together, and waits for them.
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
SOURCES = {"lstm_window": "lstm_window.cu"}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

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


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{name}-{digest}" / f"lib{name}.so"


def _start(name: str):
    """Start `nvcc` for one source unless its library exists; returns
    (target, process or None)."""
    target = _target(name)
    if target.exists():
        return target, None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, (proc, tmp)


def _finish(name: str, target: Path, job) -> str:
    if job is None:
        return ""
    proc, tmp = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{out}")
    os.replace(tmp, target)  # atomic: a reader never sees a partial file
    (target.parent / "build.log").write_text(out)
    return out


def build_all() -> dict[str, str]:
    """Compile every kernel source in parallel; returns name → compiler
    output (`-Xptxas -v` register/shared-memory report; empty when the
    library was already built)."""
    jobs = {name: _start(name) for name in SOURCES}
    return {name: _finish(name, *jobs[name]) for name in SOURCES}


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
