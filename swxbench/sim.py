"""A frozen copy of the port's device simulator, and the SWB1 encoder.

The telemetry model is `sim/simulator.py`'s `DeviceSimulator`, vectorised
over the fleet per tick:

    value[d] = base[d] + amp[d]·sin(2π·t[d]/period[d] + phase[d]) + noise

with a fraction of injected spikes (`anomaly_rate` per event, `±anomaly_
magnitude`), drawn from numpy's generator in the same order as the
original. Three changes, each kept out of the numbers: `t` may be one
sample time a device (a gateway's slice reports at its own offset in the
period), a tick returns plain columns instead of the program's batch
type, and the drift option, which no cell uses, is left out. The copy
lives here so that a later change to the program's simulator cannot move
the benchmark's traffic.

SWB1 (the program's wire format for measurements, little-endian): a
10-byte header `b"SWB1" | type u8 (1) | flags u8 | count u32`, then the
columns device_index u32[N] | mtype u16[N] | value f32[N] | ts f64[N];
18 bytes an event.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

_HEADER = struct.Struct("<4sBBI")
MAGIC = b"SWB1"
MSG_MEASUREMENTS = 1


@dataclass(frozen=True)
class SimConfig:
    num_devices: int = 1000
    base_mean: float = 21.0
    base_spread: float = 3.0
    amplitude: float = 2.0
    period_s: float = 3600.0
    noise_std: float = 0.15
    anomaly_rate: float = 0.0
    anomaly_magnitude: float = 8.0
    seed: int = 7


class DeviceSimulator:
    """A seeded fleet; each `tick` draws one reading a device."""

    def __init__(self, cfg: SimConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        n = cfg.num_devices
        self.base = (cfg.base_mean
                     + cfg.base_spread * rng.standard_normal(n)).astype(np.float32)
        self.phase = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        self.period = (cfg.period_s * rng.uniform(0.8, 1.25, n)).astype(np.float32)
        self.amp = (cfg.amplitude * rng.uniform(0.5, 1.5, n)).astype(np.float32)
        # the original draws its drifting set here; the draw stays so that
        # every later number follows the same stream
        rng.random(n)
        self.rng = rng

    def tick(self, t) -> tuple[np.ndarray, np.ndarray]:
        """One reading for every device at time `t` (a scalar or one time
        a device) → (values float32 [n], ground-truth spike mask [n])."""
        cfg = self.cfg
        n = cfg.num_devices
        # float32 as the original computes with a scalar `t`
        t = np.asarray(t, np.float32)
        clean = (self.base
                 + self.amp * np.sin(2 * np.pi * (t / self.period) + self.phase)
                 + cfg.noise_std * self.rng.standard_normal(n).astype(np.float32))
        spike = np.zeros(n, dtype=bool)
        if cfg.anomaly_rate > 0:
            spike = self.rng.random(n) < cfg.anomaly_rate
            sign = self.rng.choice(np.asarray([-1.0, 1.0], np.float32), n)
            clean = clean + spike * sign * cfg.anomaly_magnitude
        return clean.astype(np.float32), spike


def encode_swb1(device_index: np.ndarray, value: np.ndarray,
                ts: np.ndarray) -> bytes:
    """One SWB1 measurement message (channel 0 for every event)."""
    n = int(device_index.shape[0])
    return b"".join((
        _HEADER.pack(MAGIC, MSG_MEASUREMENTS, 0, n),
        np.ascontiguousarray(device_index, np.uint32).tobytes(),
        np.zeros(n, np.uint16).tobytes(),
        np.ascontiguousarray(value, np.float32).tobytes(),
        np.ascontiguousarray(ts, np.float64).tobytes(),
    ))
