"""What the port has not taken over from the JAX package yet. Each such
path raises `NotImplementedError` naming its ROADMAP item — never a
silent stub."""

from __future__ import annotations

ITEMS = {
    "A.1.5": "a bench entry for the port",
    "A.2": "mesh sharding, multi-GPU",
    "A.6": "swxlint over the port",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a cut path raises: `raise not_ported("fleet-worker", "A.5")`."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item}: {ITEMS[item]})")
