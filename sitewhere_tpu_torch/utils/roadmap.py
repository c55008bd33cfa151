"""What the port has not taken over from the JAX package yet. Each such
path raises `NotImplementedError` naming its ROADMAP item — never a
silent stub."""

from __future__ import annotations

ITEMS = {
    "A.1.2": "wire bus, remote services and serve-bus",
    "A.1.5": "the other CLI commands",
    "A.2": "mesh sharding, multi-GPU",
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a cut path raises: `raise not_ported("remote services", "A.1.2")`."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP {item}: {ITEMS[item]})")
