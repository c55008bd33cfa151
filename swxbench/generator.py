"""The one traffic generator: every mix is a data file that it reads.

A mix (`traffic/<name>.json`) sets:

- `kind`: `flood` (messages submitted back to back, the receiver's
  bounded queue the only pacing; a message the flow controller rejects
  is offered again at once, the receiver's own yield between the tries)
  or `gateway` (open loop: message i is due at `t0 + i · period /
  gateways`, sent at its due time or, when the sender ran late, at once;
  a rejected message is a failure, never resent);
- `gateways`: the fleet is cut into this many equal slices of consecutive
  devices, one message a slice each tick; a tick is one reading from
  every device;
- `rate_events_per_s` (gateway): the fleet reports once a period,
  `period = devices / rate`;
- `tick_s`: simulated seconds between a device's readings; the warm
  history's tick j is stamped `tick_s · j`, and a message's time stamp is
  `t0 + tick_s·k + g·tick_s/gateways` for tick k and gateway g, and its
  readings are drawn at that time;
- `anomaly_rate`, `anomaly_magnitude`: the simulator's spikes;
- `warmup_messages`: messages sent at the mix's own pacing before the
  window, then drained.

Readings come from the frozen simulator (`sim.py`) seeded by `--seed`;
tick k's readings are drawn once and kept, because the reference works
each device's state out again from every reading it was sent. A flood's
set-up draws `FLOOD_TICKS` ticks, and its tick k sends the readings of
tick `k mod FLOOD_TICKS` at its own time stamp: the window never draws,
whatever rate the program reaches (drawing a 32,768-device tick takes
about a millisecond and a half of the loop).
"""

from __future__ import annotations

import math

import numpy as np

from swxbench.sim import DeviceSimulator, SimConfig, encode_swb1

KINDS = ("flood", "gateway")
FLOOD_TICKS = 512


class TrafficPlan:
    """Messages, their devices, time stamps and readings for one run."""

    def __init__(self, params: dict, devices: int, warm_ticks: int,
                 seed: int):
        kind = params["kind"]
        if kind not in KINDS:
            raise ValueError(f"unknown traffic kind {kind!r} (known: {KINDS})")
        self.kind = kind
        self.params = params
        self.devices = int(devices)
        self.gateways = int(params.get("gateways", 1))
        if self.devices % self.gateways:
            raise ValueError(f"{self.devices} devices do not cut into "
                             f"{self.gateways} equal gateway slices")
        self.slice = self.devices // self.gateways
        self.tick_s = float(params.get("tick_s", 60.0))
        self.warm_ticks = int(warm_ticks)
        # the window's first tick follows the warm history
        self.t0 = self.tick_s * self.warm_ticks
        if kind == "gateway":
            self.rate = float(params["rate_events_per_s"])
            self.period_s = self.devices / self.rate
            self.interval_s = self.period_s / self.gateways
        else:
            self.rate = None
            self.period_s = self.interval_s = None
        self.distinct = FLOOD_TICKS if kind == "flood" else None
        self.warmup_messages = int(params.get("warmup_messages", 0))
        self.sim = DeviceSimulator(SimConfig(
            num_devices=self.devices, seed=seed,
            anomaly_rate=float(params.get("anomaly_rate", 0.0)),
            anomaly_magnitude=float(params.get("anomaly_magnitude", 8.0))))
        self._offsets = (np.repeat(np.arange(self.gateways), self.slice)
                         * (self.tick_s / self.gateways))
        self._dev = np.arange(self.devices, dtype=np.uint32)
        # warm history first, from the same stream
        self.warm = np.stack([self.sim.tick(self.tick_s * j)[0]
                              for j in range(self.warm_ticks)]) \
            if self.warm_ticks else np.zeros((0, self.devices), np.float32)
        self.ticks: list[np.ndarray] = []

    # -- readings -------------------------------------------------------------

    def tick_values(self, k: int) -> np.ndarray:
        """Tick k's readings, every device (drawn in order, once; a flood
        cycles through its distinct ticks)."""
        if self.distinct is not None:
            k %= self.distinct
        while len(self.ticks) <= k:
            j = len(self.ticks)
            self.ticks.append(self.sim.tick(
                self.t0 + self.tick_s * j + self._offsets)[0])
        return self.ticks[k]

    def prefill(self, seconds: float) -> None:
        """Draw ahead the ticks a window of `seconds` needs (a flood: the
        ticks it cycles through, which serve any rate)."""
        if self.kind == "flood":
            n = self.distinct
        else:
            n = (math.ceil(seconds * self.rate / self.devices)
                 + math.ceil(self.warmup_messages / self.gateways) + 2)
        self.tick_values(n - 1)

    # -- messages -------------------------------------------------------------

    def split(self, i: int) -> tuple[int, int]:
        """Message i → (tick, gateway)."""
        return divmod(i, self.gateways)

    def ts(self, i: int) -> float:
        k, g = self.split(i)
        return self.t0 + self.tick_s * k + g * (self.tick_s / self.gateways)

    def payload(self, i: int) -> bytes:
        k, g = self.split(i)
        lo, hi = g * self.slice, (g + 1) * self.slice
        return encode_swb1(self._dev[lo:hi], self.tick_values(k)[lo:hi],
                           np.full(self.slice, self.ts(i)))

    def message_of_ts(self, ts: np.ndarray) -> np.ndarray:
        """Scored time stamps → message numbers; -1 where a time stamp is
        no message's."""
        x = (np.asarray(ts, np.float64) - self.t0) * (self.gateways
                                                      / self.tick_s)
        m = np.rint(x)
        ok = (np.abs(x - m) < 1e-6) & (m >= 0)
        return np.where(ok, m, -1).astype(np.int64)
