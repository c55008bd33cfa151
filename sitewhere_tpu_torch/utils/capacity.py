"""Grow-by-doubling capacity policy, shared by every dynamically sized
structure (host telemetry tables, the device-resident scoring ring).
Growth stays geometric so reallocations are amortized.
"""

from __future__ import annotations


def grow_pow2(n: int, floor: int = 1, multiple: int = 1) -> int:
    """Smallest power-of-two-style capacity ≥ `n`.

    Doubles from `floor` until it covers `n`, then rounds up to a
    multiple of `multiple`. `floor` controls the minimum allocation;
    pass the current capacity to get the next-growth size."""
    cap = max(floor, multiple, 1)
    while cap < n:
        cap *= 2
    return ((cap + multiple - 1) // multiple) * multiple
