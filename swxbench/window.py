"""One run's traffic: warm-up, the measured window, the drain.

The sender drives the tenant's in-proc `default` queue receiver
(`receiver.submit`, SWB1 payloads) from the traffic plan, and one
consumer of the tenant's scored-events topic records every scored batch
with its arrival time on the host's monotonic clock. Both run on the
program's event loop, as a client in the same process would; the
consumer only keeps references, and the bookkeeping happens after the
drain. With a trace, a `Stretch` profiles a steady part of the window.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field

POLL_RECORDS = 512
DRAIN_TIMEOUT_S = 120.0
# a pipeline idle this long has nothing more to deliver
IDLE_S = 2.0


@dataclass
class RunRecord:
    """What a run sent and received, on the host's monotonic clock."""
    plan: object
    first_window_message: int = 0
    # per message i: when it was due (gateway) or first offered (flood),
    # when the receiver took it, whether it was accepted
    due: list = field(default_factory=list)
    taken: list = field(default_factory=list)
    accepted: list = field(default_factory=list)
    accepted_events: int = 0
    rejections: int = 0
    batches: list = field(default_factory=list)   # (arrival, ScoredBatch)
    t_window0: float = 0.0
    t_window1: float = 0.0
    t_drained: float = 0.0
    drained: bool = False

    @property
    def window_s(self) -> float:
        return self.t_window1 - self.t_window0

    @property
    def messages(self) -> int:
        return len(self.due)


class ScoredConsumer:
    """Reads the scored-events topic into `record.batches`."""

    def __init__(self, dep, record: RunRecord, group: str = "swxbench"):
        topic = dep.scored_topic
        self.consumer = dep.rt.bus.subscribe(topic, group=group)
        # from the topic's end: records of an earlier run in this process
        # (the sweep's) are not this run's
        self.consumer.commit({
            (topic, p): end
            for p, end in enumerate(dep.rt.bus.end_offsets(topic))})
        self.record = record
        self.events = 0
        self.task = None

    def start(self) -> None:
        self.task = asyncio.get_running_loop().create_task(self._run())

    async def _run(self) -> None:
        append = self.record.batches.append
        while True:
            recs = await self.consumer.poll(max_records=POLL_RECORDS,
                                            timeout=0.5)
            now = time.monotonic()
            for rec in recs:
                append((now, rec.value))
                self.events += len(rec.value)

    async def stop(self) -> None:
        self.task.cancel()
        try:
            await self.task
        except asyncio.CancelledError:
            pass
        self.consumer.close()


async def _offer(dep, plan, record: RunRecord, i: int, due: float,
                 retry: bool) -> None:
    payload = plan.payload(i)
    ok = await dep.receiver.submit(payload)
    # a rejecting submit yields to the loop before it returns
    while not ok and retry:
        record.rejections += 1
        ok = await dep.receiver.submit(payload)
    if not ok:
        record.rejections += 1
    record.due.append(due)
    record.taken.append(time.monotonic())
    record.accepted.append(bool(ok))
    if ok:
        record.accepted_events += plan.slice


async def _send(dep, plan, record: RunRecord, first: int,
                count: int | None, t_start: float,
                t_end: float | None) -> None:
    """Messages `first`, `first + 1`, ...: `count` of them, or (a flood)
    until `t_end`, or (a gateway) every one due before `t_end`. A flood
    offers the next message as soon as the receiver took the last."""
    i = first
    if plan.kind == "flood":
        while (count is None or i < first + count) and (
                t_end is None or time.monotonic() < t_end):
            await _offer(dep, plan, record, i, time.monotonic(), retry=True)
            i += 1
        return
    while count is None or i < first + count:
        due = t_start + (i - first) * plan.interval_s
        if t_end is not None and due >= t_end:
            return
        wait = due - time.monotonic()
        if wait > 0:
            await asyncio.sleep(wait)
        await _offer(dep, plan, record, i, due, retry=False)
        i += 1


async def _drain(dep, consumer: ScoredConsumer, want: int,
                 timeout: float) -> bool:
    """Wait until `want` scored events arrived and the pipeline is idle;
    False when it stays idle short of them, or at the timeout."""
    deadline = time.monotonic() + timeout
    idle_since = None
    while time.monotonic() < deadline:
        if dep.idle:
            if consumer.events >= want:
                return True
            idle_since = idle_since or time.monotonic()
            if time.monotonic() - idle_since > IDLE_S:
                return False
        else:
            idle_since = None
        await asyncio.sleep(0.02)
    return False


async def run(dep, plan, seconds: float, stretch=None) -> RunRecord:
    """Warm up, drive the window for `seconds`, drain. A flood's sender is
    stopped at the window's end (a message the receiver had not yet taken
    was never offered); a gateway sends every message due in the window."""
    record = RunRecord(plan=plan)
    consumer = ScoredConsumer(dep, record)
    consumer.start()
    try:
        # warm-up at the mix's own pacing, then everything drained
        await _send(dep, plan, record, 0, plan.warmup_messages,
                    time.monotonic(), None)
        record.drained = await _drain(dep, consumer, record.accepted_events,
                                      DRAIN_TIMEOUT_S)
        await asyncio.sleep(0.2)
        record.first_window_message = record.messages
        if stretch is not None:
            stretch.prepare()
        record.t_window0 = time.monotonic()
        t_end = record.t_window0 + seconds
        sender = asyncio.get_running_loop().create_task(_send(
            dep, plan, record, record.first_window_message, None,
            record.t_window0, t_end))
        if stretch is not None:
            await stretch.run(dep, consumer, record.t_window0, seconds)
        if plan.kind == "flood":
            await asyncio.sleep(max(t_end - time.monotonic(), 0.0))
            sender.cancel()
            try:
                await sender
            except asyncio.CancelledError:
                pass
        else:
            await sender
        record.t_window1 = t_end
        record.drained = record.drained and await _drain(
            dep, consumer, record.accepted_events, DRAIN_TIMEOUT_S)
        record.t_drained = time.monotonic()
        # late duplicates would land now: give them a beat to show
        await asyncio.sleep(0.2)
    finally:
        await consumer.stop()
    return record
