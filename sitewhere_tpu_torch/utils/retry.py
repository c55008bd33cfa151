"""Async retry-with-backoff, shared by the scoring warmup/regrow paths.

The invariant all callers need: the task must NEVER die with the ready
gate closed — both the attempt AND the recovery run inside the protected
scope, and the loop only exits when an attempt succeeds.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable, Optional


async def retry_backoff(attempt_fn: Callable[[], Awaitable[None]],
                        recover_fn: Optional[Callable[[], None]],
                        logger: logging.Logger, what: str,
                        max_sleep: float = 30.0) -> None:
    """Run `attempt_fn` until it succeeds; on failure run `recover_fn`
    (its own failure is logged, never raised) and sleep with exponential
    backoff. Cancellation propagates."""
    attempt = 0
    while True:
        try:
            await attempt_fn()
            return
        except asyncio.CancelledError:
            raise
        except Exception:
            logger.exception("%s failed (attempt %d); retrying", what, attempt)
            if recover_fn is not None:
                try:
                    recover_fn()
                except Exception:
                    logger.exception("%s recovery failed; retrying anyway",
                                     what)
            await asyncio.sleep(min(2.0 ** attempt, max_sleep))
            attempt += 1
