"""The scored-batch delivery contract shared by every settle path."""

from __future__ import annotations

import logging
import time

logger = logging.getLogger(__name__)


async def deliver_scored(sink, scored, sink_failures, stage_sink,
                         label: str = "") -> None:
    """One settled `ScoredBatch` into a scoring sink:

    - a sink failure is counted (`scoring.sink_failures`) and isolated —
      it can never kill the settle task;
    - `scoring.stage_sink_s` (settled → published) is observed here only
      for sinks that don't own the stage themselves (`owns_sink_stage`)."""
    t_sink = time.monotonic()
    try:
        await sink(scored)
    except Exception:  # noqa: BLE001 - sink errors can't kill settles
        sink_failures.inc()
        logger.exception("scoring sink failed%s",
                         f" for {label}" if label else "")
    else:
        if not getattr(sink, "owns_sink_stage", False):
            stage_sink.observe(time.monotonic() - t_sink)
