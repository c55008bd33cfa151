"""Dead-letter quarantine for poison records.

The platform promise (PAPER.md §1): one misbehaving device never takes
down a tenant's pipeline. Before this module, a record whose handler
raised killed the whole consuming loop; now every bus poll loop wraps
per-record handling and routes the failing record here instead —
processing continues and the offset commits PAST the poison record.

A dead letter is a plain dict on the per-tenant
`TopicNaming.DEAD_LETTER` topic, carrying full provenance:

    {"original_topic": ..., "partition": ..., "offset": ...,
     "key": ..., "value": <the original record value>,
     "stage": <component path that failed>,
     "error": "ValueError: ...", "quarantined_at": epoch_s}

Replay re-produces the original value onto its original topic (same
key, so partition affinity holds) and commits the replay group's
offset past it, so repeated replays never duplicate. A record that is
still poisonous simply returns to the DLQ with a fresh offset.

Surfaces: REST `GET /api/dlq` + `POST /api/dlq/replay` (rest/api.py)
and `swx dlq list|replay` (cli.py).
"""

from __future__ import annotations

import logging
import time
from typing import Optional

logger = logging.getLogger(__name__)

# error summaries ride the bus and REST responses — bound them
_ERR_MAX = 500


def summarize_error(exc: BaseException) -> str:
    return f"{type(exc).__name__}: {exc}"[:_ERR_MAX]


def _trace_of(value) -> tuple[int, int]:
    """(trace_id, n_events) of a record value's batch ctx, (0, 0) when
    the value has none — poison may blow up on any attribute access, so
    every read is defensive."""
    try:
        trace_id = int(getattr(getattr(value, "ctx", None), "trace_id", 0))
    except Exception:  # noqa: BLE001 - poison defends itself
        return 0, 0
    try:
        n = len(value)
    except Exception:  # noqa: BLE001
        n = 0
    return trace_id, n


async def quarantine(bus, dlq_topic: str, record, exc: BaseException,
                     stage: str, metrics=None,
                     tenant_id: Optional[str] = None,
                     tracer=None, fence=None) -> None:
    """Publish a poison record to the tenant's dead-letter topic.

    Never raises: a DLQ publish failure is logged and counted — the
    consuming loop must keep draining either way. `fence` is the
    data-path fencing token (kernel/bus.py): a zombie owner's
    quarantine publish is rejected like any other data-path write."""
    t0 = time.monotonic()
    entry = {
        "original_topic": record.topic,
        "partition": record.partition,
        "offset": record.offset,
        "key": record.key,
        "value": record.value,
        "stage": stage,
        "error": summarize_error(exc),
        "quarantined_at": time.time(),
    }
    try:
        await bus.produce(dlq_topic, entry, key=record.key, fence=fence)
    except Exception:  # noqa: BLE001 - quarantine must not re-poison the loop
        logger.exception("dead-letter publish to %s failed for %s@%d",
                         dlq_topic, record.topic, record.offset)
        if metrics is not None:
            metrics.counter("dlq.publish_failures").inc()
        return
    logger.warning("%s: quarantined poison record %s[%d]@%d to %s (%s)",
                   stage, record.topic, record.partition, record.offset,
                   dlq_topic, entry["error"])
    if metrics is not None:
        metrics.counter("dlq.quarantined").inc()
        if tenant_id:
            metrics.counter(f"dlq.quarantined:{tenant_id}").inc()
    if tracer is not None:
        # the quarantine is part of the record's journey: a sampled
        # trace that dead-letters shows WHERE it left the pipeline
        trace_id, n = _trace_of(record.value)
        tracer.record(trace_id, "dlq.quarantine", tenant_id or "",
                      t0, time.monotonic() - t0, n)


def list_dead_letters(bus, dlq_topic: str, limit: int = 100) -> list:
    """Newest `limit` dead letters as (TopicRecord, entry-dict) pairs.

    Needs the in-proc bus (direct log peek); callers on a wire bus get
    an AttributeError they should surface as 'not supported here'."""
    return [(r, r.value) for r in bus.peek(dlq_topic, limit=limit)
            if isinstance(r.value, dict) and "original_topic" in r.value]


async def replay_dead_letters(bus, dlq_topic: str, *,
                              limit: Optional[int] = None,
                              metrics=None, flow=None,
                              tenant_id: Optional[str] = None,
                              tracer=None, fence=None) -> int:
    """Re-produce dead letters onto their original topics; returns the
    count replayed. Progress is committed under a per-topic replay
    group, so a second replay call continues where the last stopped.

    When `flow` + `tenant_id` are given, each replayed batch is charged
    against the tenant's ingress quota exactly like live traffic — a
    replay can NOT bypass flow control and re-trigger the overload that
    dead-lettered the records in the first place. An over-quota replay
    stops early (the record stays uncommitted, so a later call resumes
    with it) and reports how far it got."""
    consumer = bus.subscribe(dlq_topic, group=f"{dlq_topic}.replay")
    replayed = 0
    try:
        while limit is None or replayed < limit:
            # one record per poll, committed immediately after its
            # re-produce: a produce failure mid-replay must not leave
            # already-replayed records uncommitted (the next replay call
            # would re-produce them — the duplicate this group exists
            # to prevent)
            records = consumer.poll_nowait(max_records=1)
            if not records:
                break
            entry = records[0].value
            if isinstance(entry, dict) and "original_topic" in entry:
                if flow is not None and tenant_id is not None:
                    try:
                        cost = float(len(entry["value"]))
                    except TypeError:
                        cost = 1.0
                    if not flow.admit_ingress(tenant_id,
                                              max(cost, 1.0)).admitted:
                        logger.info("dlq replay for %s paused over quota "
                                    "after %d records", tenant_id, replayed)
                        break   # NOT committed: the next replay resumes here
                t0 = time.monotonic()
                await bus.produce(entry["original_topic"], entry["value"],
                                  key=entry.get("key"), fence=fence)
                replayed += 1
                if tracer is not None:
                    # replay re-enters the pipeline under the SAME trace
                    # id: the journey shows quarantine → replay → the
                    # stages the second pass records
                    trace_id, n = _trace_of(entry["value"])
                    tracer.record(trace_id, "dlq.replay",
                                  tenant_id or "", t0,
                                  time.monotonic() - t0, n)
            # else: foreign record on the DLQ topic — skip, still commit
            consumer.commit(fence=fence)
    finally:
        consumer.close()
    if replayed and metrics is not None:
        metrics.counter("dlq.replayed").inc(replayed)
    return replayed
