"""Columnar cold tier: windowed segment compaction over the durable log.

The hot path appends `MeasurementBatch`es to a per-tenant `SegmentLog`
in SWB1 wire form (persistence/durable.py) — row-ish records, replayed
record-by-record on boot. That layout is write-optimal and read-awful:
re-scoring a day of history through it would pay per-record Python on
every event. The compactor folds *sealed* segments into per-(tenant,
time-window) **column blocks** — one codec-encoded dict of parallel
ndarray columns (`device_index` u32 | `mtype` u16 | `value` f32 | `ts`
f64) per (window, pass) — framed with the same `len | crc32 | rtype`
record header as `SegmentLog`, so the torn-tail story is identical.
Blocks decode as read-only zero-copy `frombuffer` views (kernel/codec
`copy_arrays=False`), which the replay engine packs straight into
scoring buckets.

A JSON **manifest** (written atomically: tmp + fsync + rename) indexes
every block by window start for time-range lookup and carries the
compaction high-water mark (`compacted_through_seq`). Restart-resume is
idempotent by construction: a pass that crashed after appending blocks
but before the manifest rewrite leaves unreferenced bytes in the block
file — wasted space, never duplicate reads — and the next pass re-folds
the same segments under fresh manifest entries.

Within a window, events keep **log order** (the order live scoring saw
them), so a replay of an in-order stream is record-for-record the live
sequence. A window split across passes (flush-split) comes back merged
at read: `read_range` concatenates its blocks in manifest order.
"""

from __future__ import annotations

import json
import logging
import math
import os
import struct
import threading
import time
import zlib
from typing import Iterator, Optional

import numpy as np

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.kernel import codec
from sitewhere_tpu_torch.persistence.durable import RT_MEASUREMENTS, SegmentLog

logger = logging.getLogger(__name__)

# block framing: len u32 | crc32(payload) u32 | rtype u8 — byte-identical
# to the SegmentLog record header, so both tiers share one torn-tail story
_REC = struct.Struct("<IIB")
RT_BLOCK = 1          # codec-encoded column-dict payload

_BLK_FMT = "blocks-{:08d}.blk"
_MANIFEST = "manifest.json"

COLUMNS = ("device_index", "mtype", "value", "ts")


class EventHistoryStore:
    """Cold-tier column-block store for ONE tenant's event history.

    `source` is the tenant's durable `SegmentLog`; `compact()` folds its
    sealed segments (seq < the active segment) into column blocks under
    `directory`. Single compactor at a time (the maintenance thread OR
    an explicit call — guarded); reads are manifest-driven and safe
    concurrently with compaction (the manifest swaps atomically).
    """

    def __init__(self, directory: str, source: Optional[SegmentLog] = None,
                 window_s: float = 60.0, block_events: int = 65536,
                 block_bytes: int = 64 << 20, metrics=None, faults=None):
        self.dir = directory
        self.source = source
        self.window_s = float(window_s)
        self.block_events = int(block_events)
        self.block_bytes = int(block_bytes)
        self.faults = faults
        os.makedirs(directory, exist_ok=True)
        self.compactions_c = (metrics.counter("history.compactions")
                              if metrics is not None else None)
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.tail_skips = 0        # CRC/torn tails skipped LOUDLY (counted)
        self.compaction_errors = 0
        self._load_manifest()

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> str:
        return os.path.join(self.dir, _MANIFEST)

    def _load_manifest(self) -> None:
        self.blocks: list[dict] = []
        self.compacted_through_seq = 0
        self.compactions = 0
        self._blk_seq = 1
        try:
            with open(self._manifest_path()) as f:
                m = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError):
            # an unreadable manifest orphans existing blocks (space, not
            # correctness — reads are manifest-driven) and restarts
            # compaction from the oldest live segment
            logger.warning("history: unreadable manifest at %s — "
                           "restarting compaction from scratch",
                           self._manifest_path(), exc_info=True)
            return
        self.blocks = list(m.get("blocks", []))
        self.compacted_through_seq = int(m.get("compacted_through_seq", 0))
        self.compactions = int(m.get("compactions", 0))
        self.tail_skips = int(m.get("tail_skips", 0))
        self._blk_seq = int(m.get("blk_seq", 1))

    def _save_manifest(self) -> None:
        doc = {"version": 1, "window_s": self.window_s,
               "compacted_through_seq": self.compacted_through_seq,
               "compactions": self.compactions,
               "tail_skips": self.tail_skips,
               "blk_seq": self._blk_seq,
               "blocks": self.blocks}
        tmp = self._manifest_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._manifest_path())

    # -- compaction (windowed segment fold) --------------------------------

    def _scan_segment(self, path: str) -> Iterator[tuple[int, memoryview]]:
        """Yield (rtype, payload) for one sealed segment; a torn record
        or CRC mismatch skips the segment's tail LOUDLY (counted — the
        satellite contract: corruption is visible, never silent)."""
        with open(path, "rb") as f:
            data = f.read()
        mv = memoryview(data)
        off = 0
        while off + _REC.size <= len(mv):
            ln, crc, rtype = _REC.unpack_from(mv, off)
            start = off + _REC.size
            end = start + ln
            if end > len(mv):
                self.tail_skips += 1
                logger.warning(
                    "history: torn record at %s+%d (want %d bytes, have "
                    "%d) — tail skipped, counted (%d total)", path, off,
                    ln, len(mv) - start, self.tail_skips)
                return
            payload = mv[start:end]
            if zlib.crc32(payload) != crc:
                self.tail_skips += 1
                logger.warning(
                    "history: CRC mismatch at %s+%d — tail skipped, "
                    "counted (%d total)", path, off, self.tail_skips)
                return
            yield rtype, payload
            off = end

    def compact(self, through_seq: Optional[int] = None) -> dict:
        """Fold sealed source segments newer than the high-water mark
        into column blocks. Returns a pass report. Idempotent across
        restarts: the manifest's `compacted_through_seq` advances only
        after the pass's blocks are durably indexed."""
        with self._lock:
            return self._compact_locked(through_seq)

    def _compact_locked(self, through_seq: Optional[int]) -> dict:
        t0 = time.monotonic()
        if self.faults is not None:
            self.faults.check("history.compact")
        if self.source is None:
            return {"segments": 0, "events": 0, "blocks": 0}
        if through_seq is None:
            # sealed segments only: the writer thread owns the active
            # segment's tail — compacting it would race the append
            through_seq = self.source._seq - 1
        segs = [(seq, path) for seq, path in self.source._segments()
                if self.compacted_through_seq < seq <= through_seq]
        if not segs:
            return {"segments": 0, "events": 0, "blocks": 0}
        ctx = BatchContext(tenant_id="", source="history-compact")
        pending: dict[float, list[MeasurementBatch]] = {}
        pending_n = 0
        events = blocks = 0
        last_seq = self.compacted_through_seq
        for seq, path in segs:
            for rtype, payload in self._scan_segment(path):
                if rtype != RT_MEASUREMENTS:
                    continue  # locations/cold events are not scorable
                batch = MeasurementBatch.decode(payload, ctx)
                n = len(batch)
                if n == 0:
                    continue
                wkey = np.floor(batch.ts / self.window_s) * self.window_s
                # a batch can straddle a window boundary: split by key
                # (np.unique keeps keys sorted — ts order holds within
                # each key for in-order streams)
                for w in np.unique(wkey):
                    sel = wkey == w
                    pending.setdefault(float(w), []).append(
                        batch if bool(sel.all()) else batch.select(sel))
                pending_n += n
                events += n
            last_seq = seq
            if pending_n >= self.block_events:
                blocks += self._flush_windows(pending)
                pending, pending_n = {}, 0
        blocks += self._flush_windows(pending)
        self.compacted_through_seq = last_seq
        self.compactions += 1
        self._save_manifest()
        if self.compactions_c is not None:
            self.compactions_c.inc()
        report = {"segments": len(segs), "events": events,
                  "blocks": blocks, "tail_skips": self.tail_skips,
                  "through_seq": last_seq,
                  "elapsed_s": round(time.monotonic() - t0, 3)}
        logger.info("history: compacted %d segment(s) → %d block(s), "
                    "%d events in %.3fs (through seq %d)", len(segs),
                    blocks, events, report["elapsed_s"], last_seq)
        return report

    def _flush_windows(self, pending: dict[float, list]) -> int:
        """Write one column block per accumulated window (log order
        within the window), splitting oversized windows at
        `block_events` — those splits ALSO merge back at read."""
        flushed = 0
        for w in sorted(pending):
            batches = pending[w]
            dev = np.concatenate([b.device_index for b in batches])
            mt = np.concatenate([b.mtype for b in batches])
            val = np.concatenate([b.value for b in batches])
            ts = np.concatenate([b.ts for b in batches])
            for lo in range(0, dev.shape[0], self.block_events):
                hi = lo + self.block_events
                payload = codec.encode({
                    "window": float(w),
                    "count": int(dev[lo:hi].shape[0]),
                    "device_index": np.ascontiguousarray(dev[lo:hi]),
                    "mtype": np.ascontiguousarray(mt[lo:hi]),
                    "value": np.ascontiguousarray(val[lo:hi]),
                    "ts": np.ascontiguousarray(ts[lo:hi]),
                })
                self._append_block(float(w), payload,
                                   int(dev[lo:hi].shape[0]))
                flushed += 1
        return flushed

    def _active_block_path(self) -> str:
        return os.path.join(self.dir, _BLK_FMT.format(self._blk_seq))

    def _append_block(self, window: float, payload: bytes, count: int) -> None:
        path = self._active_block_path()
        with open(path, "ab") as f:
            offset = f.tell()
            f.write(_REC.pack(len(payload), zlib.crc32(payload), RT_BLOCK))
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
            size = f.tell()
        self.blocks.append({"window": window,
                            "file": os.path.basename(path),
                            "offset": offset,
                            "length": _REC.size + len(payload),
                            "count": count})
        if size >= self.block_bytes:
            self._blk_seq += 1

    # -- readback (manifest-driven, zero-copy decode) -----------------------

    def _select(self, since: Optional[float],
                until: Optional[float]) -> list[dict]:
        lo = -math.inf if since is None else float(since)
        hi = math.inf if until is None else float(until)
        return [b for b in self.blocks if lo <= b["window"] < hi]

    def _read_block(self, entry: dict) -> Optional[dict]:
        path = os.path.join(self.dir, entry["file"])
        try:
            with open(path, "rb") as f:
                f.seek(entry["offset"])
                raw = f.read(entry["length"])
        except OSError:
            logger.warning("history: unreadable block %s+%d", path,
                           entry["offset"], exc_info=True)
            return None
        if len(raw) < _REC.size:
            logger.warning("history: truncated block %s+%d", path,
                           entry["offset"])
            return None
        ln, crc, rtype = _REC.unpack_from(raw, 0)
        payload = memoryview(raw)[_REC.size:_REC.size + ln]
        if rtype != RT_BLOCK or len(payload) != ln \
                or zlib.crc32(payload) != crc:
            logger.warning("history: corrupt block %s+%d — skipped",
                           path, entry["offset"])
            return None
        # read-only zero-copy views over the block bytes (frombuffer):
        # the flush round only READS columns
        return codec.decode(payload, copy_arrays=False)

    def read_range(self, since: Optional[float] = None,
                   until: Optional[float] = None
                   ) -> Iterator[tuple[float, dict]]:
        """Yield `(window_start, columns)` per window in `[since,
        until)` ascending. Flush-split windows merge here: a window's
        blocks concatenate in manifest (= log) order. Single-block
        windows stay zero-copy."""
        by_window: dict[float, list[dict]] = {}
        for entry in self._select(since, until):
            by_window.setdefault(entry["window"], []).append(entry)
        for w in sorted(by_window):
            decoded = [d for d in (self._read_block(e)
                                   for e in by_window[w]) if d is not None]
            if not decoded:
                continue
            if len(decoded) == 1:
                cols = {k: decoded[0][k] for k in COLUMNS}
            else:
                cols = {k: np.concatenate([d[k] for d in decoded])
                        for k in COLUMNS}
            yield w, cols

    def windows(self) -> list[float]:
        return sorted({b["window"] for b in self.blocks})

    def stats(self) -> dict:
        return {
            "window_s": self.window_s,
            "blocks": len(self.blocks),
            "windows": len({b["window"] for b in self.blocks}),
            "events": int(sum(b["count"] for b in self.blocks)),
            "bytes": int(sum(b["length"] for b in self.blocks)),
            "compactions": self.compactions,
            "compacted_through_seq": self.compacted_through_seq,
            "tail_skips": self.tail_skips,
            "compaction_errors": self.compaction_errors,
        }

    # -- background maintenance (the engine's compaction hook) ---------------

    def start_maintenance(self, interval_s: float) -> None:
        """Compact on a cadence from a dedicated thread (compaction is
        disk+numpy work — a thread keeps it entirely off the event
        loop, the same split as DurableEventLog's writer)."""
        if self._thread is not None or interval_s <= 0:
            return
        self._thread = threading.Thread(
            target=self._maintain, args=(float(interval_s),),
            name=f"swx-compact:{os.path.basename(self.dir)}", daemon=True)
        self._thread.start()

    def _maintain(self, interval_s: float) -> None:
        while not self._closed.wait(interval_s):
            try:
                self.compact()
            except Exception:  # noqa: BLE001 - maintenance must survive
                self.compaction_errors += 1
                logger.exception("history: compaction pass failed "
                                 "(%d so far); next pass retries",
                                 self.compaction_errors)

    def close(self) -> None:
        self._closed.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
