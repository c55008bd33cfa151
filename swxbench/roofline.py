"""The card's published peaks, its power limit, and the operations and
bytes of the port's hand-written kernel, counted from widths.

Peaks are NVIDIA's data sheet for one H100 SXM, dense, without sparsity:
989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM3. They
assume the full 700 W; `power_limit()` reads the card's own limit, which
every result prints beside the shares.
"""

from __future__ import annotations

import subprocess

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations or bytes."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_S)


def k1_counts(rows: float, steps: int, hidden: int,
              launches: int) -> tuple[float, float]:
    """(FLOP, bytes) of K1 (`csrc/lstm_window.cu`) over `rows` real
    windows of `steps` readings in `launches` launches: the gate products
    2·(1 + h)·4h a row and step; each input byte read once (the float32
    normalised window, the weights in bf16 and the bias in float32 once a
    launch) and each output byte written once (the float32 final h).
    Bucket padding is not work, so `rows` counts real rows only."""
    flops = 2.0 * rows * steps * (1 + hidden) * 4 * hidden
    weights = 4 * hidden * 2 + hidden * 4 * hidden * 2 + 4 * hidden * 4
    nbytes = rows * steps * 4 + rows * hidden * 4 + launches * weights
    return flops, nbytes


def device_info() -> dict:
    """The card's name and power limit as `nvidia-smi` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return {"nvidia_smi": None}
    return {"nvidia_smi": out.strip()}
