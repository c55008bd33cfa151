"""Columnar telemetry store: per-tenant `[device, time]` ring buffers.

- **Append is one pass in C++**: the store's host library
  (`csrc/swx_native.cpp`, bound in persistence/native.py and built with
  g++ at first use) lands a `MeasurementBatch` of N events with a
  cursor-chasing loop that keeps in-batch per-device order by
  construction, with the GIL released.
- **Reads are model-shaped**: `window(devices, W)` returns a `[D, W]`
  array — the scoring ring's seed and the query path's input.
- Bounded memory: ring over the time axis (length `history`), device axis
  grows by doubling.

`append_plain`, `window_plain`, `window_ts_plain` and `latest_plain` are
the library's plain versions in numpy (stable sort + per-device cumcount
for the append): the tests and the chip check hold the two bit-equal,
and nothing on the serving path calls them. There is no fallback: a
library that cannot be built raises. The scoring plane keeps its own
device-resident copy of the recent windows (scoring/ring.py) and
re-seeds it from here.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from sitewhere_tpu_torch.domain.batch import LocationBatch, MeasurementBatch
from sitewhere_tpu_torch.persistence.native import get_lib
from sitewhere_tpu_torch.utils import grow_pow2


def _check_indices(dev: np.ndarray) -> None:
    """Device indices are dense non-negative slots; a negative index would
    wrap to ~4e9 under the native paths' uint32 cast (out-of-bounds C++
    write) and silently alias a ring row under numpy — both are caller
    bugs, so fail loudly."""
    if dev.size and int(dev.min()) < 0:
        raise ValueError(f"negative device index: {int(dev.min())}")


# -- the host library's plain versions (numpy) ---------------------------------

def append_plain(table: "TelemetryTable", dev: np.ndarray,
                 values: np.ndarray, ts: np.ndarray) -> None:
    """`TelemetryTable.append` in numpy: stable sort + per-device
    cumcount keeps in-batch per-device order."""
    n = dev.shape[0]
    if n == 0:
        return
    _check_indices(dev)
    table._ensure_capacity(int(dev.max()))
    dev = dev.astype(np.int64, copy=False)
    order = np.argsort(dev, kind="stable")
    sd = dev[order]
    uniq, start, counts = np.unique(sd, return_index=True, return_counts=True)
    # position of each event within its device's run in this batch
    cum = np.arange(n, dtype=np.int64) - np.repeat(start, counts)
    pos = (table.cursor[sd] + cum) % table.history
    table.values[sd, pos] = values[order]
    table.ts[sd, pos] = ts[order]
    table.cursor[uniq] = (table.cursor[uniq] + counts) % table.history
    table.count[uniq] = np.minimum(table.count[uniq] + counts, table.history)
    table.total_appended += n


def window_plain(table: "TelemetryTable", devices: np.ndarray,
                 w: int) -> tuple[np.ndarray, np.ndarray]:
    """`TelemetryTable.window` in numpy."""
    _check_indices(devices)
    table._ensure_capacity(int(devices.max()) if devices.size else 0)
    devices = devices.astype(np.int64, copy=False)
    idx = (table.cursor[devices, None] - w + np.arange(w)[None, :]) % table.history
    out = table.values[devices[:, None], idx]
    valid = np.arange(w)[None, :] >= (w - np.minimum(table.count[devices], w)[:, None])
    return out, valid


def window_ts_plain(table: "TelemetryTable", devices: np.ndarray,
                    w: int) -> np.ndarray:
    """`TelemetryTable.window_ts` in numpy."""
    _check_indices(devices)
    table._ensure_capacity(int(devices.max()) if devices.size else 0)
    devices = devices.astype(np.int64, copy=False)
    idx = (table.cursor[devices, None] - w + np.arange(w)[None, :]) % table.history
    return table.ts[devices[:, None], idx]


def latest_plain(table: "TelemetryTable",
                 devices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """`TelemetryTable.latest` in numpy."""
    _check_indices(devices)
    table._ensure_capacity(int(devices.max()) if devices.size else 0)
    devices = devices.astype(np.int64, copy=False)
    idx = (table.cursor[devices] - 1) % table.history
    return table.values[devices, idx], table.ts[devices, idx]


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
        """Ring append preserving in-batch per-device order: one
        cursor-chasing pass in the host library (GIL released)."""
        n = dev.shape[0]
        if n == 0:
            return
        _check_indices(dev)
        self._ensure_capacity(int(dev.max()))
        get_lib().swx_telemetry_append(
            self.values, self.ts, self.cursor, self.count,
            self.capacity, self.history,
            np.ascontiguousarray(dev, np.uint32),
            np.ascontiguousarray(values, np.float32),
            np.ascontiguousarray(ts, np.float64), n)
        self.total_appended += n

    def window(self, devices: np.ndarray, w: int) -> tuple[np.ndarray, np.ndarray]:
        """Last `w` values per device → (`[D, w]` float32, `[D, w]` bool valid).

        Devices with fewer than `w` points are left-padded; padding slots are
        marked invalid. Output is chronological (oldest → newest).
        """
        _check_indices(devices)
        self._ensure_capacity(int(devices.max()) if devices.size else 0)
        n = devices.shape[0]
        out = np.empty((n, w), np.float32)
        valid = np.empty((n, w), np.uint8)
        if n:
            get_lib().swx_window_gather(
                self.values, self.cursor, self.count, self.history,
                np.ascontiguousarray(devices, np.uint32), n, w, out, valid)
        return out, valid.view(bool)

    def window_ts(self, devices: np.ndarray, w: int) -> np.ndarray:
        _check_indices(devices)
        self._ensure_capacity(int(devices.max()) if devices.size else 0)
        n = devices.shape[0]
        out = np.empty((n, w), np.float64)
        if n:
            get_lib().swx_window_ts_gather(
                self.ts, self.cursor, self.history,
                np.ascontiguousarray(devices, np.uint32), n, w, out)
        return out

    def latest(self, devices: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Most recent (value, ts) per device; ts==0 where never written."""
        _check_indices(devices)
        self._ensure_capacity(int(devices.max()) if devices.size else 0)
        n = devices.shape[0]
        val_out = np.empty(n, np.float32)
        ts_out = np.empty(n, np.float64)
        if n:
            get_lib().swx_latest(self.values, self.ts, self.cursor,
                                 self.history,
                                 np.ascontiguousarray(devices, np.uint32), n,
                                 val_out, ts_out)
        return val_out, ts_out


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

    def append_values(self, dev: np.ndarray, values: np.ndarray,
                      ts: np.ndarray, mtype: int = 0) -> int:
        """Bulk scalar append into one channel without a
        MeasurementBatch envelope — internal series writers (the fleet
        forecaster's tenant-0 store, backfills from durable history)
        that have columns in hand, not wire batches."""
        dev = np.asarray(dev, np.int64)
        table = self.channel(mtype)
        with self._lock:
            table.append(dev, np.asarray(values, np.float32),
                         np.asarray(ts, np.float64))
        return int(dev.shape[0])

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
