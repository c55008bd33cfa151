"""Dependency-free asyncio HTTP/1.1 client bits shared by the outbound
webhook connector and the HTTP command-delivery provider.

http:// only — this image terminates TLS at the edge; an https URL
raises at config time rather than silently downgrading.
"""

from __future__ import annotations

import asyncio
from urllib.parse import urlsplit


def parse_http_url(url: str, what: str = "endpoint") -> tuple[str, int, str]:
    """→ (host, port, path+query); raises ValueError on non-http."""
    parts = urlsplit(url)
    if parts.scheme != "http":
        raise ValueError(f"{what} supports http:// only, got {url!r}")
    path = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
    return parts.hostname or "127.0.0.1", parts.port or 80, path


async def http_post(host: str, port: int, path: str, body: bytes,
                    content_type: str = "application/json",
                    timeout_s: float = 10.0) -> int:
    """One-shot POST; returns the status code. ONE bound over connect +
    write/drain + status read: an endpoint that accepts but stops
    reading must not wedge the caller past the timeout."""

    async def attempt() -> int:
        reader, writer = await asyncio.open_connection(host, port)
        try:
            writer.write(
                (f"POST {path} HTTP/1.1\r\nHost: {host}\r\n"
                 f"Content-Type: {content_type}\r\n"
                 f"Content-Length: {len(body)}\r\n"
                 f"Connection: close\r\n\r\n").encode() + body)
            await writer.drain()
            status_line = await reader.readline()
            return int(status_line.split()[1])
        finally:
            writer.close()

    return await asyncio.wait_for(attempt(), timeout_s)


async def http_post_retrying(host: str, port: int, path: str, body: bytes,
                             content_type: str = "application/json",
                             retries: int = 3, backoff_s: float = 0.2,
                             timeout_s: float = 10.0,
                             ) -> tuple[bool, Exception | None]:
    """POST with exponential-backoff retries; 2xx wins. Returns
    (delivered, last_error) so each caller keeps its own accounting
    (delivered/failed counters vs dead-letter republish)."""
    delay = backoff_s
    last: Exception | None = None
    for attempt in range(max(1, retries)):
        try:
            status = await http_post(host, port, path, body,
                                     content_type=content_type,
                                     timeout_s=timeout_s)
            if 200 <= status < 300:
                return True, None
            last = RuntimeError(f"HTTP {status}")
        except (OSError, asyncio.TimeoutError, ValueError,
                IndexError) as exc:
            last = exc
        if attempt < retries - 1:
            await asyncio.sleep(delay)
            delay *= 2
    return False, last
