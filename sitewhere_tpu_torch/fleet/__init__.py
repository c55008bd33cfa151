"""Fleet control plane: multi-worker tenant sharding over a shared bus.

ROADMAP item 2 made concrete: the platform is production-grade inside
one process, and this package is what takes it past one host's ceiling.
A fleet is

- a **shared bus tier** — one broker process hosting the `EventBus`
  over the wire (`kernel/wire.py BusServer`); every tenant topic and
  every consumer group lives there, so ownership of a tenant is nothing
  more than *which process runs its consumer loops*;
- **N worker processes** — each a `ServiceRuntime` with
  `fleet_managed=True` attached via `RemoteEventBus`, hosting the
  scoring pipeline (device-mgmt, inbound, event-mgmt, device-state,
  rule-processing) for exactly the tenants placement assigns it
  (`FleetWorker`, worker.py);
- a **controller** — placement (weighted rendezvous,
  `parallel/placement.py`), drain-then-handoff rebalancing, worker
  liveness via heartbeats, and the backlog-driven autoscaler (the ADApt
  replica-prediction loop, PAPERS.md arXiv 2504.03698) consuming each
  worker's TelemetryBeat-derived signals (`FleetController`,
  controller.py).

Everything converges through ONE control topic
(`<instance>.instance.fleet-control`): heartbeats, placement epochs,
and release acknowledgements. The handoff protocol reuses the
committed-offset resume semantics the lane toggles proved safe: the
old owner stops its consumers (settle barriers commit
through), publishes a release, and only then does the new owner start
engines — at-least-once preserved, never dual-ownership. A dead
worker's tenants reassign automatically and resume from committed
offsets. docs/FLEET.md is the operator runbook.
"""

from sitewhere_tpu_torch.fleet.controller import AutoscalerPolicy, FleetController
from sitewhere_tpu_torch.fleet.forecast import FeaturePipeline, PredictivePlanner
from sitewhere_tpu_torch.fleet.observer import FleetObserver
from sitewhere_tpu_torch.fleet.worker import FleetWorker

__all__ = ["FleetController", "FleetWorker", "AutoscalerPolicy",
           "FleetObserver", "FeaturePipeline", "PredictivePlanner"]
