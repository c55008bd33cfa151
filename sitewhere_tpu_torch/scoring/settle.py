"""Shared settle executor: device→host readbacks wait on the card, so
every session settles its results on this one pool of worker threads
instead of blocking the event loop."""

from concurrent.futures import ThreadPoolExecutor

SETTLE_POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="swx-settle")
