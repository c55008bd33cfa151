"""Deterministic tenant→worker placement: weighted rendezvous hashing.

The fleet control plane (sitewhere_tpu_torch/fleet) shards tenants across N
worker processes against a shared bus tier. Placement must be

- **deterministic**: every observer (controller, workers, tests) derives
  the identical map from the same (tenants, workers) inputs — no
  process-local hash seeds (PYTHONHASHSEED), no iteration-order luck;
- **stable**: adding or removing one worker moves only the tenants that
  must move (the rendezvous property) — every unnecessary move is a
  drain-and-handoff the pipeline pays for;
- **weight-aware**: a tenant's flow-config weight is its load share
  (kernel/flow.py DRR uses the same number), so one heavy tenant should
  not stack onto the worker already holding two others.

The algorithm is highest-random-weight (rendezvous) hashing over a
keyed SHA-256 — each tenant ranks every worker by hash score and takes
the top choice — plus a deterministic capacity pass: tenants place in
descending weight order, and a tenant skips down its preference list
while the candidate worker's summed weight exceeds `headroom ×
total/len(workers)`. With uniform weights and default headroom the
capacity pass is a no-op and placement is pure rendezvous.
"""

from __future__ import annotations

import hashlib
from typing import Mapping, Sequence

_MAX64 = float(1 << 64)


def _score(tenant_id: str, worker_id: str) -> float:
    """Uniform (0, 1] hash score for the (tenant, worker) pair."""
    digest = hashlib.sha256(
        f"{tenant_id}\x00{worker_id}".encode()).digest()[:8]
    return (int.from_bytes(digest, "little") + 1) / _MAX64


def rendezvous_rank(tenant_id: str, workers: Sequence[str]) -> list[str]:
    """Workers ordered by this tenant's preference (highest score
    first; worker-id tiebreak keeps the order total)."""
    return sorted(workers, key=lambda w: (-_score(tenant_id, w), w))


def compute_placement(tenant_weights: Mapping[str, float],
                      workers: Sequence[str], *,
                      headroom: float = 1.25) -> dict[str, str]:
    """tenant_id → worker_id over the live worker set.

    `tenant_weights` maps tenant id to its load weight (flow-config
    `weight`, ≥0; non-positive weights count as 1.0). Empty worker set
    returns an empty map — callers treat unplaced tenants as pending.
    """
    live = sorted(set(workers))
    if not live or not tenant_weights:
        return {}
    weights = {t: (w if w and w > 0 else 1.0)
               for t, w in tenant_weights.items()}
    cap = headroom * sum(weights.values()) / len(live)
    load = {w: 0.0 for w in live}
    assignment: dict[str, str] = {}
    # heaviest first: light tenants pack around the big ones, not the
    # other way round (and the order is total, so the map is stable)
    for tid in sorted(weights, key=lambda t: (-weights[t], t)):
        prefs = rendezvous_rank(tid, live)
        pick = next((w for w in prefs if load[w] + weights[tid] <= cap),
                    None)
        if pick is None:
            # nothing under cap (one tenant heavier than cap, or a tight
            # tail): least-loaded wins, preference order breaks ties
            pick = min(live, key=lambda w: (load[w], prefs.index(w)))
        assignment[tid] = pick
        load[pick] += weights[tid]
    return assignment


def placement_moves(old: Mapping[str, str],
                    new: Mapping[str, str]) -> list[str]:
    """Tenants whose owner changes between two maps (each move is one
    drain-and-handoff; the controller counts them as rebalance cost)."""
    return sorted(t for t, w in new.items() if old.get(t) not in (None, w))


__all__ = ["compute_placement", "rendezvous_rank", "placement_moves"]
