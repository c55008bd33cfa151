"""Device-resident telemetry ring: per-device history on the card.

The hot scoring path never ships windows: per-device history lives on
the device as a ring `values [capacity+1, window]` float32 with `count`
and `cursor` `[capacity+1]` int32 (row `capacity` is a scratch row that
absorbs padding writes), and one step does

    scatter (append new values) → gather (per-device window) → score

so a flush transfers only the deltas — device ids (int32) + values
(float32), 8 bytes/event — and returns the scores. Where the JAX ring
donates its buffers so XLA updates them in place, this ring updates its
tensors in place with `index_put_`.

The scorer is chosen once, by the model's configuration: a model with a
fused scorer (`score_fused`, the window kernel for single-layer bf16
LSTMs) uses it, every other model uses `score`. A failed kernel build or
launch raises; nothing falls back to another path.

The host-side `TelemetryStore` stays the durable copy; `load()` re-syncs
the ring from it at warmup or after a failed dispatch.
"""

from __future__ import annotations

import numpy as np
import torch

from sitewhere_tpu_torch.ops import lstm_kernel
from sitewhere_tpu_torch.utils import grow_pow2, resolve_device


def torch_dtype(name):
    """`"float16"` → `torch.float16`; a dtype or None passes through."""
    return getattr(torch, name) if isinstance(name, str) else name


def check_ids(dev: np.ndarray, limit: int) -> None:
    """Refuse, on the host, a device id outside `[0, limit)`: on the card
    an out-of-range index is a device-side assert that ends the process's
    CUDA context (JAX's scatter drops it instead), so every id is checked
    before any launch. Callers keep ids in range by growing the ring
    first (the session's regrow, the pool's `_pending_max` check)."""
    if dev.size and (int(dev.min()) < 0 or int(dev.max()) >= limit):
        raise IndexError(f"device ids {int(dev.min())}..{int(dev.max())} "
                         f"outside the ring's rows [0, {limit})")


def _gather_windows(values, count, cursor, dev):
    """(x, valid) windows of rows `dev` of one ring: x chronological,
    valid marking the newest `count` slots."""
    w = values.shape[-1]
    steps = torch.arange(w, device=values.device)
    idx = (cursor[dev].long()[:, None] - w + steps[None, :]) % w
    x = values[dev[:, None], idx]
    valid = steps[None, :] >= (w - count[dev])[:, None]
    return x, valid


def _ring_rows(values: np.ndarray, count: np.ndarray, w: int):
    """Host windows (chronological, left-padded) → ring form: the valid
    suffix at positions 0..count-1, the cursor at the next slot."""
    cnt = np.minimum(count.astype(np.int32), w)
    idx = (np.arange(w)[None, :] + (w - cnt)[:, None]) % w
    return np.take_along_axis(values.astype(np.float32), idx, axis=1), cnt


class DeviceRing:
    """Ring of one scalar channel for up to `capacity` devices, resident
    on `device` (the card unless named)."""

    def __init__(self, window: int = 64, capacity: int = 1024,
                 score_dtype=None, device=None):
        self.device = resolve_device(device)
        self.window = int(window)
        self.capacity = grow_pow2(int(capacity), floor=1024)
        # narrow flush-path score readback (float16 halves the only
        # per-event device→host payload); settle upcasts on assignment
        self.score_dtype = torch_dtype(score_dtype)
        self.faulted = False  # True after a dispatch failed mid-update
        self._alloc(self.capacity)

    @property
    def kernel_launches(self) -> int:
        """Fused window kernel launches so far (process-wide counter)."""
        return lstm_kernel.launches

    # -- state -------------------------------------------------------------

    def _alloc(self, cap: int) -> None:
        w, dev = self.window, self.device
        self.values = torch.zeros((cap + 1, w), dtype=torch.float32, device=dev)
        self.count = torch.zeros(cap + 1, dtype=torch.int32, device=dev)
        self.cursor = torch.zeros(cap + 1, dtype=torch.int32, device=dev)

    def ensure_capacity(self, max_index: int) -> None:
        """Grow (device-side) so `max_index` is a valid device row."""
        if max_index < self.capacity:
            return
        new_cap = grow_pow2(max_index + 1, floor=self.capacity * 2)
        old_values, old_count, old_cursor = self.values, self.count, self.cursor
        # drop the old scratch row (its contents are garbage), zero-extend,
        # append a fresh scratch row
        self._alloc(new_cap)
        self.values[:self.capacity] = old_values[:-1]
        self.count[:self.capacity] = old_count[:-1]
        self.cursor[:self.capacity] = old_cursor[:-1]
        self.capacity = new_cap

    def load(self, values: np.ndarray, count: np.ndarray,
             start: int = 0) -> None:
        """Overwrite rows `start..start+n` from host window data.

        `values[n, window]` is chronological with left padding (the
        `TelemetryStore.window` layout); `count[n]` is valid entries per
        row. Ring form places the valid suffix at positions `0..count-1`
        with the cursor pointing at the next slot.
        """
        n, w = values.shape
        assert w == self.window
        self.ensure_capacity(start + n - 1 if n else 0)
        ring_rows, cnt = _ring_rows(values, count, w)
        self.values[start:start + n] = torch.from_numpy(ring_rows).to(self.device)
        self.count[start:start + n] = torch.from_numpy(cnt).to(self.device)
        self.cursor[start:start + n] = torch.from_numpy(cnt % w).to(self.device)
        self.faulted = False

    # -- the fused step ----------------------------------------------------

    def _gather(self, dev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return _gather_windows(self.values, self.count, self.cursor, dev)

    def _pad(self, dev: np.ndarray, v: np.ndarray, bucket: int):
        check_ids(dev, self.capacity)
        n = dev.shape[0]
        out_dev = np.full(bucket, self.capacity, np.int64)  # scratch row
        out_v = np.zeros(bucket, np.float32)
        out_dev[:n] = dev
        out_v[:n] = v
        return (torch.from_numpy(out_dev).to(self.device),
                torch.from_numpy(out_v).to(self.device))

    def update_and_score(self, model, params, dev: np.ndarray,
                         v: np.ndarray, bucket: int) -> torch.Tensor:
        """Append `v[i]` to ring row `dev[i]` (unique ids!), score every
        touched device's window; returns `[bucket]` scores on the device
        (asynchronous — the caller settles off the event loop)."""
        score = getattr(model, "score_fused", model.score)
        w = self.window
        pdev, pv = self._pad(dev, v, bucket)
        try:
            # in place: ids are unique apart from the scratch row, whose
            # contents are garbage by design
            pos = self.cursor[pdev].long()
            self.values.index_put_((pdev, pos), pv)
            self.cursor.index_put_((pdev,), ((pos + 1) % w).int())
            self.count.index_put_((pdev,), (self.count[pdev] + 1).clamp_(max=w))
            x, valid = self._gather(pdev)
            scores = score(params, x, valid)
            if self.score_dtype is not None:
                scores = scores.to(self.score_dtype)
        except Exception:
            self.faulted = True  # partial update; needs load()
            raise
        return scores

    def windows(self, dev: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident (x, valid) windows for `dev` — the query path."""
        d = torch.from_numpy(np.asarray(dev, np.int64)).to(self.device)
        return self._gather(d)

    def close(self) -> None:
        """Release the ring's device memory; it is unusable afterwards."""
        self.values = self.count = self.cursor = None


class StackedDeviceRing:
    """Per-tenant device rings stacked on a leading tenant axis — the
    pooled twin of `DeviceRing`, resident on `device` (the card unless
    named).

    State is `values [T_cap, D_cap+1, window]`, `count`/`cursor`
    `[T_cap, D_cap+1]`; one dispatch appends and scores every tenant:
    the scatter and gather index flat rows `t * (D_cap + 1) + dev`, then
    `model.score` runs vmapped over the tenant axis with each tenant's
    params from the stack. The fused window kernel takes one weight set,
    so the pooled path keeps `score`, as the reference's does. Padding
    writes land in each tenant's scratch row `D_cap`.
    """

    def __init__(self, window: int, n_tenants: int, device_cap: int = 1024,
                 score_dtype=None, device=None):
        self.device = resolve_device(device)
        self.window = int(window)
        self.t_cap = int(n_tenants)
        self.device_cap = grow_pow2(int(device_cap), floor=1024)
        self.score_dtype = torch_dtype(score_dtype)
        self.faulted = False
        self._alloc()

    def _alloc(self) -> None:
        t, d, w, dev = self.t_cap, self.device_cap, self.window, self.device
        self.values = torch.zeros((t, d + 1, w), dtype=torch.float32,
                                  device=dev)
        self.count = torch.zeros((t, d + 1), dtype=torch.int32, device=dev)
        self.cursor = torch.zeros((t, d + 1), dtype=torch.int32, device=dev)

    def ensure(self, n_tenants: int, max_device: int) -> None:
        """Grow either axis (device-side). The tenant axis adopts
        `n_tenants` exactly — it must equal the param stack's capacity
        (vmap needs matching leading dims)."""
        new_t = max(self.t_cap, n_tenants)
        new_d = self.device_cap
        if max_device >= new_d:
            new_d = grow_pow2(max_device + 1, floor=new_d * 2)
        if new_t == self.t_cap and new_d == self.device_cap:
            return
        old_t, old_d = self.t_cap, self.device_cap
        old = (self.values, self.count, self.cursor)
        self.t_cap, self.device_cap = new_t, new_d
        self._alloc()
        # drop each tenant's old scratch row; new rows and tenants start
        # empty with a fresh scratch row
        for new, prev in zip((self.values, self.count, self.cursor), old):
            new[:old_t, :old_d] = prev[:, :-1]

    def load_tenant(self, slot: int, values: np.ndarray,
                    count: np.ndarray) -> None:
        """Seed one tenant's rings from host window data (chronological,
        left-padded — the `TelemetryStore.window` layout)."""
        n, w = values.shape
        assert w == self.window
        self.ensure(slot + 1, n - 1 if n else 0)
        ring_rows, cnt = _ring_rows(values, count, w)
        self.values[slot, :n] = torch.from_numpy(ring_rows).to(self.device)
        self.count[slot, :n] = torch.from_numpy(cnt).to(self.device)
        self.cursor[slot, :n] = torch.from_numpy(cnt % w).to(self.device)
        self.faulted = False

    def clear_tenant(self, slot: int) -> None:
        """Zero a departed tenant's rings (slot reuse must not leak)."""
        self.values[slot] = 0.0
        self.count[slot] = 0
        self.cursor[slot] = 0

    def leaves(self) -> dict:
        """The state tensors, each `[T_cap, D_cap+1, ...]`."""
        return {"values": self.values, "count": self.count,
                "cursor": self.cursor}

    def update_and_score(self, model, stacked_params, dev: np.ndarray,
                         v: np.ndarray) -> torch.Tensor:
        """dev: [T_cap, B] int32 (scratch-row-padded, unique ids per
        tenant row!), v: [T_cap, B] float32 → [T_cap, B] scores on the
        device (asynchronous)."""
        if dev.shape[0] != self.t_cap or v.shape != dev.shape:
            raise ValueError(f"dispatch columns {dev.shape}/{v.shape} do "
                             f"not match the ring's {self.t_cap} tenants")
        check_ids(dev, self.device_cap + 1)  # the scratch row included
        w, stride = self.window, self.device_cap + 1
        pdev = torch.from_numpy(dev.astype(np.int64)).to(self.device)
        pv = torch.from_numpy(np.asarray(v, np.float32)).to(self.device)
        tenant = torch.arange(self.t_cap, device=self.device)
        rows = (pdev + stride * tenant[:, None]).reshape(-1)
        values = self.values.view(-1, w)
        count, cursor = self.count.view(-1), self.cursor.view(-1)
        try:
            pos = cursor[rows].long()
            values.index_put_((rows, pos), pv.reshape(-1))
            cursor.index_put_((rows,), ((pos + 1) % w).int())
            count.index_put_((rows,), (count[rows] + 1).clamp_(max=w))
            x, valid = _gather_windows(values, count, cursor, rows)
            scores = torch.func.vmap(model.score)(
                stacked_params, x.view(*dev.shape, w),
                valid.view(*dev.shape, w))
            if self.score_dtype is not None:
                scores = scores.to(self.score_dtype)
        except Exception:
            self.faulted = True  # partial update; needs reseeding
            raise
        return scores

    def windows(self, slot: int,
                dev: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
        """Device-resident (x, valid) windows of tenant `slot`'s devices
        `dev` — the query path."""
        d = torch.from_numpy(np.asarray(dev, np.int64)).to(self.device)
        return _gather_windows(self.values[slot], self.count[slot],
                               self.cursor[slot], d)

    def close(self) -> None:
        """Release the rings' device memory; they are unusable afterwards."""
        self.values = self.count = self.cursor = None
