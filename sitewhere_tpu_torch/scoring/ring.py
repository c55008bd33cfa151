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
        self.score_dtype = (getattr(torch, score_dtype)
                            if isinstance(score_dtype, str) else score_dtype)
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
        cnt = np.minimum(count.astype(np.int32), w)
        # shift each row left by (w - cnt) so valid data sits at 0..cnt-1
        idx = (np.arange(w)[None, :] + (w - cnt)[:, None]) % w
        ring_rows = np.take_along_axis(values.astype(np.float32), idx, axis=1)
        self.values[start:start + n] = torch.from_numpy(ring_rows).to(self.device)
        self.count[start:start + n] = torch.from_numpy(cnt).to(self.device)
        self.cursor[start:start + n] = torch.from_numpy(cnt % w).to(self.device)
        self.faulted = False

    # -- the fused step ----------------------------------------------------

    def _gather(self, dev: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.window
        steps = torch.arange(w, device=self.device)
        idx = (self.cursor[dev].long()[:, None] - w + steps[None, :]) % w
        x = self.values[dev[:, None], idx]
        valid = steps[None, :] >= (w - self.count[dev])[:, None]
        return x, valid

    def _pad(self, dev: np.ndarray, v: np.ndarray, bucket: int):
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
