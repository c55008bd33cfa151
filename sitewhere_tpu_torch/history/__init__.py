"""Historical replay plane: columnar cold tier + full-speed replay.

The durable event log (persistence/durable.py) makes yesterday's
traffic recoverable; this package makes it *re-scorable*. Two planes
over one ingest path: the streaming plane scores events at ingress speed, the
historical plane folds sealed log segments into per-(tenant, window)
columnar blocks (`EventHistoryStore`) and streams any time range back
through the megabatch scoring path at hardware speed (`ReplayEngine`) —
dense columns in, zero per-record Python, replay traffic riding the
same internal-slot discipline as tenant-0.

On top: shadow-scoring regression (`ReplayEngine.compare` /
`guard_swap`) — replay one window under the live params and a candidate
checkpoint, diff the scores per tenant, and gate `swap_params`
promotion on the divergence bar. The port's copy of the JAX package's
history/: the block and manifest formats are the same, and replay scores
through the port's `SharedScoringPool` on the pool's device.
"""

from sitewhere_tpu_torch.history.replay import (
    DivergenceGateError,
    ReplayEngine,
    ReplayFenceError,
    ScoreCollector,
)
from sitewhere_tpu_torch.history.store import EventHistoryStore

__all__ = [
    "DivergenceGateError",
    "EventHistoryStore",
    "ReplayEngine",
    "ReplayFenceError",
    "ScoreCollector",
]
