"""The port's main path at full width, as `chip_smoke.py` drives it.

A dedicated `ScoringSession` scoring the windowed `lstm` model (W=64,
h=64, 1 layer, bf16, random weights from seed 0) over a 32,768-device
simulated fleet, buckets 256…16384, its store filled with W+4 ticks and
the session warmed. `chip_smoke.py` and `tools/flush_profile.py` build
it here, so both measure the same session. Needs one CUDA card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

SEED = 0
BUCKETS = (256, 1024, 4096, 16384)
WINDOW, HIDDEN = 64, 64
FLEET = 32768
TICK_S = 60.0


@dataclass
class MainPath:
    model: Any
    store: TelemetryStore
    sim: DeviceSimulator
    sim_cfg: SimConfig
    metrics: MetricsRegistry
    session: ScoringSession
    tenant: str
    t: float  # time of the first tick after the store fill

    def ingest(self, batch: MeasurementBatch) -> None:
        """One gateway batch through SWB1 encode → decode → host store →
        admit, as the service's ingress hands it to the session."""
        wire = MeasurementBatch.decode(
            batch.encode(), BatchContext(tenant_id=self.tenant,
                                         source="gateway"))
        self.store.append_measurements(wire)
        self.session.admit(wire)


def build(tenant: str) -> MainPath:
    model = build_model("lstm", window=WINDOW, hidden=HIDDEN)
    store = TelemetryStore(history=128, initial_devices=FLEET)
    sim_cfg = SimConfig(num_devices=FLEET, seed=SEED)
    sim = DeviceSimulator(sim_cfg, tenant_id=tenant)
    for k in range(WINDOW + 4):
        store.append_measurements(sim.tick(t=TICK_S * k)[0])
    metrics = MetricsRegistry()
    session = ScoringSession(model, store, metrics,
                             ScoringConfig(buckets=BUCKETS, capacity=FLEET))
    session.warmup()
    return MainPath(model, store, sim, sim_cfg, metrics, session, tenant,
                    TICK_S * (WINDOW + 4))
