"""Device simulator: synthetic telemetry fleets, the traffic source.

Telemetry model (vectorized over the whole fleet per tick):
  value[d] = base[d] + amp[d]·sin(2π·(t/period[d]) + phase[d]) + noise
with a configurable fraction of injected anomalies (spikes) whose
ground-truth mask is returned alongside — scoring checks measure
detection against it. Same seed, same numbers as the JAX package's
simulator (both draw from numpy's generator in the same order).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch


@dataclass(frozen=True)
class SimConfig:
    num_devices: int = 1000
    base_mean: float = 21.0        # °C
    base_spread: float = 3.0
    amplitude: float = 2.0
    period_s: float = 3600.0
    noise_std: float = 0.15
    anomaly_rate: float = 0.0      # per-event probability of a spike
    anomaly_magnitude: float = 8.0 # added to value (in noise-std units ≫ 1)
    # degradation drift: a fixed fraction of devices ramp linearly in time
    drift_fraction: float = 0.0
    drift_per_hour: float = 0.0    # units added per hour of sim time
    seed: int = 7


class DeviceSimulator:
    """Stateful fleet simulator; each tick yields one columnar batch."""

    def __init__(self, cfg: SimConfig, tenant_id: str = "default"):
        self.cfg = cfg
        self.tenant_id = tenant_id
        rng = np.random.default_rng(cfg.seed)
        n = cfg.num_devices
        self.base = (cfg.base_mean
                     + cfg.base_spread * rng.standard_normal(n)).astype(np.float32)
        self.phase = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
        self.period = (cfg.period_s * rng.uniform(0.8, 1.25, n)).astype(np.float32)
        self.amp = (cfg.amplitude * rng.uniform(0.5, 1.5, n)).astype(np.float32)
        self.rng = rng
        self._device_index = np.arange(n, dtype=np.uint32)
        self._mtype = np.zeros(n, dtype=np.uint16)
        # ground-truth degrading set (fixed per simulator instance); drift
        # accumulates from the first tick's timestamp
        self.drifting = rng.random(n) < cfg.drift_fraction
        self._drift_t0: float | None = None

    def tick(self, t: float | None = None,
             devices: np.ndarray | None = None) -> tuple[MeasurementBatch, np.ndarray]:
        """One reading per device → (batch, ground-truth anomaly mask)."""
        cfg = self.cfg
        t = time.time() if t is None else t
        idx = self._device_index if devices is None else devices.astype(np.uint32)
        d = idx.astype(np.int64)
        clean = (self.base[d]
                 + self.amp[d] * np.sin(2 * np.pi * (t / self.period[d])
                                        + self.phase[d])
                 + cfg.noise_std * self.rng.standard_normal(d.size).astype(np.float32))
        if cfg.drift_per_hour:
            if self._drift_t0 is None:
                self._drift_t0 = t
            drifting = self.drifting[d]
            clean = clean + drifting * (cfg.drift_per_hour
                                        * (t - self._drift_t0) / 3600.0)
        anomaly = np.zeros(d.size, dtype=bool)
        if cfg.anomaly_rate > 0:
            anomaly = self.rng.random(d.size) < cfg.anomaly_rate
            sign = self.rng.choice(np.asarray([-1.0, 1.0], np.float32), d.size)
            clean = clean + anomaly * sign * cfg.anomaly_magnitude
        batch = MeasurementBatch(
            BatchContext(tenant_id=self.tenant_id, source="simulator"),
            idx,
            self._mtype[: d.size] if devices is None else np.zeros(d.size, np.uint16),
            clean.astype(np.float32),
            np.full(d.size, t, np.float64),
        )
        return batch, anomaly

    def payload(self, t: float | None = None) -> tuple[bytes, np.ndarray]:
        """One tick encoded as an SWB1 wire payload (gateway emulation)."""
        batch, truth = self.tick(t)
        return batch.encode(), truth
