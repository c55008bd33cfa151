"""Device-result helpers shared by the scoring settle paths.

A flush's scores leave the card as soon as they are dispatched:
`start_to_host` queues a non-blocking copy into pinned host memory on
the current stream and records a CUDA event behind it. The event loop
polls `result_ready` (an event query, never a sync), and a settle thread
calls `result_to_host`, which waits on that one event — never a
device-wide `torch.cuda.synchronize()`. On the CPU a result is ready at
once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class DeviceResult:
    """Host copy of a device tensor, complete once `event` has fired
    (`event` is None for a CPU tensor: the copy is already there)."""

    host: torch.Tensor
    event: Optional[torch.cuda.Event] = None


def start_to_host(out: torch.Tensor) -> DeviceResult:
    """Begin the device→host copy of `out` without blocking."""
    if out.device.type != "cuda":
        return DeviceResult(out.detach())
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out.device))
    return DeviceResult(host, event)


def result_ready(res: DeviceResult) -> bool:
    return res.event is None or res.event.query()


def result_to_host(res: DeviceResult) -> np.ndarray:
    """Settle-thread conversion: wait for this result's copy, then view it
    as numpy."""
    if res.event is not None:
        res.event.synchronize()
    return res.host.numpy()
