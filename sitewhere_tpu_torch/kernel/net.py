"""Shared asyncio-server shutdown helper.

Python 3.12's `Server.wait_closed()` waits for live connection HANDLERS,
so every TCP listener must close its tracked client writers at stop or a
peer holding a connection open (normal keep-alive behavior) wedges
shutdown. All seven listeners use this helper (REST, Kafka, STOMP, AMQP,
WebSocket, MQTT, TCP gateway) — including the accept/stop race: a
handler task created just before `close()` hasn't registered its writer
yet, so we yield and re-close for a few passes to catch late joiners.
"""

from __future__ import annotations

import asyncio


async def shutdown_server(server: asyncio.AbstractServer | None,
                          writers: set, passes: int = 3) -> None:
    """Close the listener, then tracked client writers (multi-pass to
    cover handlers whose accept raced the shutdown), then wait for
    handler completion."""
    if server is None:
        return
    server.close()
    for _ in range(passes):
        for w in list(writers):
            w.close()
        await asyncio.sleep(0)
    await server.wait_closed()
