"""Columnar telemetry store: per-tenant `[device, time]` ring buffers.

- **Append is vectorized**: one `MeasurementBatch` of N events lands with
  a handful of numpy scatter ops regardless of N, including correct
  in-batch per-device ordering (stable sort + per-device cumcount).
- **Reads are model-shaped**: `window(devices, W)` returns a `[D, W]`
  array — the scoring ring's seed and the query path's input.
- Bounded memory: ring over the time axis (length `history`), device axis
  grows by doubling.

Host-only numpy (the JAX package's native C++ paths are ROADMAP A.3);
the scoring plane keeps its own device-resident copy of
the recent windows (scoring/ring.py) and re-seeds it from here.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from sitewhere_tpu_torch.domain.batch import LocationBatch, MeasurementBatch
from sitewhere_tpu_torch.utils import grow_pow2


def _check_indices(dev: np.ndarray) -> None:
    """Device indices are dense non-negative slots; a negative index would
    silently alias a ring row under numpy — a caller bug, so fail loudly."""
    if dev.size and int(dev.min()) < 0:
        raise ValueError(f"negative device index: {int(dev.min())}")


class TelemetryTable:
    """Ring buffer of one scalar channel for up to `capacity` devices."""

    def __init__(self, history: int = 1024, initial_devices: int = 1024):
        self.history = history
        self.capacity = initial_devices
        self.values = np.zeros((initial_devices, history), np.float32)
        self.ts = np.zeros((initial_devices, history), np.float64)
        self.cursor = np.zeros(initial_devices, np.int64)   # next write pos
        self.count = np.zeros(initial_devices, np.int64)    # valid entries
        self.total_appended = 0

    def _ensure_capacity(self, max_index: int) -> None:
        if max_index < self.capacity:
            return
        new_cap = grow_pow2(max_index + 1, floor=self.capacity * 2)
        for name in ("values", "ts"):
            old = getattr(self, name)
            grown = np.zeros((new_cap, self.history), old.dtype)
            grown[: self.capacity] = old
            setattr(self, name, grown)
        for name in ("cursor", "count"):
            old = getattr(self, name)
            grown = np.zeros(new_cap, old.dtype)
            grown[: self.capacity] = old
            setattr(self, name, grown)
        self.capacity = new_cap

    def append(self, dev: np.ndarray, values: np.ndarray, ts: np.ndarray) -> None:
        """Ring append preserving in-batch per-device order (stable sort +
        per-device cumcount)."""
        n = dev.shape[0]
        if n == 0:
            return
        _check_indices(dev)
        self._ensure_capacity(int(dev.max()))
        dev = dev.astype(np.int64, copy=False)
        order = np.argsort(dev, kind="stable")
        sd = dev[order]
        uniq, start, counts = np.unique(sd, return_index=True, return_counts=True)
        # position of each event within its device's run in this batch
        cum = np.arange(n, dtype=np.int64) - np.repeat(start, counts)
        pos = (self.cursor[sd] + cum) % self.history
        self.values[sd, pos] = values[order]
        self.ts[sd, pos] = ts[order]
        self.cursor[uniq] = (self.cursor[uniq] + counts) % self.history
        self.count[uniq] = np.minimum(self.count[uniq] + counts, self.history)
        self.total_appended += n

    def window(self, devices: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray]:
        """Last `w` values per device → (`[D, w]` float32, `[D, w]` bool valid).

        Devices with fewer than `w` points are left-padded; padding slots are
        marked invalid. Output is chronological (oldest → newest).
        """
        _check_indices(devices)
        self._ensure_capacity(int(devices.max()) if devices.size else 0)
        devices = devices.astype(np.int64, copy=False)
        idx = (self.cursor[devices, None] - w + np.arange(w)[None, :]) % self.history
        out = self.values[devices[:, None], idx]
        valid = np.arange(w)[None, :] >= (w - np.minimum(self.count[devices], w)[:, None])
        return out, valid

    def window_ts(self, devices: np.ndarray, w: int) -> np.ndarray:
        _check_indices(devices)
        self._ensure_capacity(int(devices.max()) if devices.size else 0)
        devices = devices.astype(np.int64, copy=False)
        idx = (self.cursor[devices, None] - w + np.arange(w)[None, :]) % self.history
        return self.ts[devices[:, None], idx]

    def latest(self, devices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Most recent (value, ts) per device; ts==0 where never written."""
        _check_indices(devices)
        self._ensure_capacity(int(devices.max()) if devices.size else 0)
        devices = devices.astype(np.int64, copy=False)
        idx = (self.cursor[devices] - 1) % self.history
        return self.values[devices, idx], self.ts[devices, idx]


class LocationTable:
    """Ring buffer of GPS fixes per device (lat/lon/elev/ts)."""

    def __init__(self, history: int = 64, initial_devices: int = 1024):
        self.history = history
        self.capacity = initial_devices
        self.lat = np.zeros((initial_devices, history), np.float64)
        self.lon = np.zeros((initial_devices, history), np.float64)
        self.elev = np.zeros((initial_devices, history), np.float32)
        self.ts = np.zeros((initial_devices, history), np.float64)
        self.cursor = np.zeros(initial_devices, np.int64)
        self.count = np.zeros(initial_devices, np.int64)

    def _ensure_capacity(self, max_index: int) -> None:
        if max_index < self.capacity:
            return
        new_cap = grow_pow2(max_index + 1, floor=self.capacity * 2)
        for name in ("lat", "lon", "elev", "ts"):
            old = getattr(self, name)
            grown = np.zeros((new_cap, self.history), old.dtype)
            grown[: self.capacity] = old
            setattr(self, name, grown)
        for name in ("cursor", "count"):
            old = getattr(self, name)
            grown = np.zeros(new_cap, old.dtype)
            grown[: self.capacity] = old
            setattr(self, name, grown)
        self.capacity = new_cap

    def append(self, batch: LocationBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        dev = batch.device_index.astype(np.int64, copy=False)
        self._ensure_capacity(int(dev.max()))
        order = np.argsort(dev, kind="stable")
        sd = dev[order]
        uniq, start, counts = np.unique(sd, return_index=True, return_counts=True)
        cum = np.arange(n, dtype=np.int64) - np.repeat(start, counts)
        pos = (self.cursor[sd] + cum) % self.history
        self.lat[sd, pos] = batch.latitude[order]
        self.lon[sd, pos] = batch.longitude[order]
        self.elev[sd, pos] = batch.elevation[order]
        self.ts[sd, pos] = batch.ts[order]
        self.cursor[uniq] = (self.cursor[uniq] + counts) % self.history
        self.count[uniq] = np.minimum(self.count[uniq] + counts, self.history)

    def latest(self, devices: np.ndarray):
        devices = devices.astype(np.int64, copy=False)
        self._ensure_capacity(int(devices.max()) if devices.size else 0)
        idx = (self.cursor[devices] - 1) % self.history
        return (self.lat[devices, idx], self.lon[devices, idx],
                self.elev[devices, idx], self.ts[devices, idx])


class TelemetryStore:
    """Per-tenant telemetry: one TelemetryTable per measurement channel
    (`mtype`) plus one LocationTable. Thread-safe for the append path."""

    def __init__(self, history: int = 1024, initial_devices: int = 1024):
        self.history = history
        self.initial_devices = initial_devices
        self.channels: dict[int, TelemetryTable] = {}
        self.locations = LocationTable(initial_devices=initial_devices)
        self._lock = threading.Lock()

    def channel(self, mtype: int) -> TelemetryTable:
        table = self.channels.get(mtype)
        if table is None:
            with self._lock:
                table = self.channels.get(mtype)
                if table is None:
                    table = TelemetryTable(self.history, self.initial_devices)
                    self.channels[mtype] = table
        return table

    def append_measurements(self, batch: MeasurementBatch) -> int:
        """Scatter a batch into the per-channel tables; returns N."""
        mtypes = np.unique(batch.mtype)
        if mtypes.size == 1:
            table = self.channel(int(mtypes[0]))
            with self._lock:
                table.append(batch.device_index, batch.value, batch.ts)
        else:
            for mt in mtypes:
                mask = batch.mtype == mt
                table = self.channel(int(mt))
                with self._lock:
                    table.append(batch.device_index[mask], batch.value[mask],
                                 batch.ts[mask])
        return len(batch)

    def append_locations(self, batch: LocationBatch) -> int:
        with self._lock:
            self.locations.append(batch)
        return len(batch)

    def window(self, devices: np.ndarray, w: int,
               mtype: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Scoring-session entry: last-w window for one channel."""
        return self.channel(mtype).window(devices, w)

    def snapshot(self, mtype: int = 0,
                 max_devices: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        """Dataset view: copies (values[D, T], count[D]) for a channel,
        chronological per device (oldest → newest)."""
        table = self.channel(mtype)
        with self._lock:
            d = table.capacity if max_devices is None else min(max_devices, table.capacity)
            devices = np.arange(d)
            vals, _ = table.window(devices, table.history)
            return vals.copy(), table.count[:d].copy()

    @property
    def total_events(self) -> int:
        return sum(t.total_appended for t in self.channels.values())
