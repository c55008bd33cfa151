"""What a run's scored records say, and whether they are correct.

Every scored record on the tenant's topic names its device and carries the
time stamp of the message it came in, so it maps back to one event that
was sent. From that:

- exactly once: each event of an accepted message is on the topic once,
  none of a rejected message is, and no record is any event's
  (`lost`, `duplicated`, `unknown`: limit 0 each). A rejected message's
  events are failures of the run, not faults of its output;
- the anomaly flag of every record is its score against the tenant's
  threshold (`flags`: limit 0);
- persist: the store's last `history` readings and time stamps of every
  sampled device equal what was sent to it (`persisted`: limit 0);
- scores: every event of the sampled devices, against the plain
  reference worked out again from the warm history and every reading
  sent (`score_gap`: the largest |served − reference| / max(1,
  |reference|), limit from `limits/<cell>.json`).

The sampled devices are drawn from the seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Scored:
    """The run's scored records as flat columns, one row an event."""
    device: np.ndarray
    message: np.ndarray
    score: np.ndarray
    flag: np.ndarray
    arrival: np.ndarray


def flatten(record) -> Scored:
    plan = record.plan
    if not record.batches:
        e = np.zeros(0)
        return Scored(e.astype(np.int64), e.astype(np.int64),
                      e.astype(np.float32), e.astype(bool), e)
    dev = np.concatenate([b.device_index for _, b in record.batches])
    ts = np.concatenate([b.ts for _, b in record.batches])
    return Scored(
        device=dev.astype(np.int64),
        message=plan.message_of_ts(ts),
        score=np.concatenate([b.score for _, b in record.batches]),
        flag=np.concatenate([b.is_anomaly for _, b in record.batches]),
        arrival=np.repeat([t for t, _ in record.batches],
                          [len(b) for _, b in record.batches]))


@dataclass
class Tally:
    attempted: int
    failed: int
    lost: int
    duplicated: int
    unknown: int


def tally(record, scored: Scored) -> Tally:
    """Each event's count on the topic, against what was accepted."""
    plan = record.plan
    n_msg = record.messages
    accepted = np.asarray(record.accepted, bool)
    g = scored.device // plan.slice
    ok = ((scored.message >= 0) & (scored.message < n_msg)
          & (scored.device >= 0) & (scored.device < plan.devices)
          & (scored.message % plan.gateways == g))
    unknown = int((~ok).sum())
    key = scored.message[ok] * plan.slice + (scored.device[ok] % plan.slice)
    counts = np.bincount(key, minlength=n_msg * plan.slice).reshape(
        n_msg, plan.slice)
    expect = accepted[:, None]
    lost = int((expect & (counts == 0)).sum())
    duplicated = int((counts > 1).sum())
    unknown += int((~expect & (counts > 0)).sum())
    window = slice(record.first_window_message, n_msg)
    attempted = (n_msg - record.first_window_message) * plan.slice
    failed = int((counts[window] != 1).sum())
    return Tally(attempted, failed, lost, duplicated, unknown)


def sample_devices(devices: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    return np.sort(rng.choice(devices, size=min(n, devices), replace=False))


def flag_mismatches(scored: Scored, threshold: float) -> int:
    return int((scored.flag != (scored.score >= threshold)).sum())


def sent_sequences(record, devices: np.ndarray) -> dict:
    """Per gateway: (the sampled devices it carries, the accepted
    messages' ticks in the order sent)."""
    plan = record.plan
    accepted = np.asarray(record.accepted, bool)
    out = {}
    for g in np.unique(devices // plan.slice):
        devs = devices[devices // plan.slice == g]
        msgs = np.arange(g, record.messages, plan.gateways)
        msgs = msgs[accepted[msgs]]
        out[int(g)] = (devs, msgs)
    return out


def sent_values(plan, devs: np.ndarray, msgs: np.ndarray) -> np.ndarray:
    """Readings [len(devs), warm + len(msgs)] as sent: the warm history,
    then each accepted message of their gateway in order."""
    cols = [plan.warm[:, devs].T]
    if len(msgs):
        cols.append(np.stack([plan.tick_values(int(k))[devs]
                              for k in msgs // plan.gateways], axis=1))
    return np.concatenate(cols, axis=1)


def served_scores(scored: Scored, devs: np.ndarray,
                  msgs: np.ndarray) -> np.ndarray:
    """Served scores [len(devs), len(msgs)]; NaN where none was served."""
    out = np.full((devs.shape[0], msgs.shape[0]), np.nan, np.float32)
    row = np.full(max(int(scored.device.max(initial=0)),
                      int(devs.max(initial=0))) + 1, -1, np.int64)
    row[devs] = np.arange(devs.shape[0])
    col = np.full(max(int(scored.message.max(initial=0)),
                      int(msgs.max(initial=0))) + 1, -1, np.int64)
    col[msgs] = np.arange(msgs.shape[0])
    m = scored.message >= 0
    r = np.where(m, row[np.where(m, scored.device, 0)], -1)
    c = np.where(m, col[np.where(m, scored.message, 0)], -1)
    sel = (r >= 0) & (c >= 0)
    out[r[sel], c[sel]] = scored.score[sel]
    return out


def persisted_mismatches(record, em, devices: np.ndarray,
                         history: int) -> int:
    """Sampled devices whose store windows (readings and time stamps)
    differ from the last `history` readings sent to them."""
    plan = record.plan
    x, valid = em.telemetry.window(devices.astype(np.int64), history)
    ts = em.telemetry.channel(0).window_ts(devices.astype(np.int64), history)
    bad = 0
    for g, (devs, msgs) in sent_sequences(record, devices).items():
        rows = np.searchsorted(devices, devs)
        sent_v = sent_values(plan, devs, msgs)
        sent_t = np.concatenate(
            [plan.tick_s * np.arange(plan.warm_ticks, dtype=np.float64),
             np.asarray([plan.ts(int(i)) for i in msgs], np.float64)])
        n = min(history, sent_v.shape[1])
        want_v, want_t = sent_v[:, -n:], sent_t[-n:]
        got_v, got_t = x[rows][:, -n:], ts[rows][:, -n:]
        ok = ((got_v.view(np.uint32) == want_v.view(np.uint32)).all(axis=1)
              & (got_t == want_t[None, :]).all(axis=1)
              & valid[rows][:, -n:].all(axis=1))
        bad += int((~ok).sum())
    return bad


def score_gap(served: np.ndarray, ref: np.ndarray) -> float:
    """The largest |served − reference| / max(1, |reference|); inf where
    an event was not served."""
    if served.size == 0:
        return 0.0
    if np.isnan(served).any():
        return float("inf")
    return float((np.abs(served.astype(np.float64) - ref)
                  / np.maximum(1.0, np.abs(ref))).max())


def gap_worst(served: np.ndarray, ref: np.ndarray, n: int = 5) -> dict:
    """How many sampled events lie over 1e-2 and the worst few, as
    [device row, event, served, reference] (a diagnosis only)."""
    if served.size == 0 or np.isnan(served).any():
        return {"over_1e-2": None, "worst": []}
    gap = np.abs(served.astype(np.float64) - ref) / np.maximum(1.0, np.abs(ref))
    flat = np.argsort(gap, axis=None)[::-1][:n]
    rows, cols = np.unravel_index(flat, gap.shape)
    return {"over_1e-2": int((gap > 1e-2).sum()),
            "worst": [[int(r), int(c), float(served[r, c]), float(ref[r, c])]
                      for r, c in zip(rows, cols)]}
