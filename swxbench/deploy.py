"""A cell's deployment, built through the port's public runtime API.

The configuration file (`configs/<name>.json`) holds the deployment as
data: the instance settings (`instance`), the tenant's sections
(`sections`, the recipe of the program's `tools/pipeline.tenant_sections`
copied as data), the fleet size (`devices`) and the warm history
(`warm_ticks` readings a device, appended straight into the store, then
the scoring ring reloaded from it). The harness imports nothing from the
program's `tools`: it builds the runtime with `cli.build_runtime`, adds
the tenant, registers the fleet, fills the store, hands the tenant's
engine the parameters that the harness made (`swap_model_params`) and
waits until every bucket is warm.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any

import numpy as np

READY_TIMEOUT_S = 300.0


@dataclass
class Deployment:
    rt: Any
    engine: Any        # the tenant's rule-processing engine
    sink: Any          # its pool slot or dedicated session
    em: Any            # its event-management engine
    receiver: Any      # the tenant's in-proc "default" queue receiver
    tenant: str

    @property
    def scored_topic(self) -> str:
        from sitewhere_tpu_torch.kernel.bus import TopicNaming

        return self.rt.naming.tenant_topic(self.tenant,
                                           TopicNaming.SCORED_EVENTS)

    def counter(self, name: str) -> int:
        return int(self.rt.metrics.counter(name).value)

    @property
    def idle(self) -> bool:
        """Nothing pending or in flight in the scorer and the egress, and
        every consumer group of the tenant (persist, device state, the
        fast lane) committed through the end of its topics."""
        egress = self.engine.egress
        if (self.sink.pending_n or self.sink.inflight
                or (egress is not None and not egress.idle)):
            return False
        prefix = f"{self.tenant}."
        return all(lag == 0
                   for group, lags in self.rt.bus.group_lags().items()
                   if group.startswith(prefix) for lag in lags.values())

    async def stop(self) -> None:
        await self.rt.stop()


async def deploy(config: dict, warm: np.ndarray, tick_s: float, params: dict,
                 trace_sample: int, device=None) -> Deployment:
    """Build, fill and warm the configuration's deployment; `warm` is the
    warm history [ticks, devices] (tick j at `tick_s · j`, the traffic
    mix's), `params` the
    model's parameters in the program's layout. `device` None is the
    card (the CPU only in the harness's own tests)."""
    from sitewhere_tpu_torch.cli import build_runtime
    from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
    from sitewhere_tpu_torch.domain.model import DeviceType

    settings = dict(config["instance"])
    settings["trace_sample"] = int(trace_sample)
    rt = build_runtime(InstanceSettings(device=device,
                                        engine_ready_timeout_s=READY_TIMEOUT_S,
                                        **settings))
    await rt.start()
    try:
        tenant = config["tenant"]
        await rt.add_tenant(TenantConfig(tenant_id=tenant,
                                         sections=config["sections"]),
                            timeout=READY_TIMEOUT_S)
        dm = rt.api("device-management").management(tenant)
        em = rt.api("event-management").management(tenant)
        n = int(config["devices"])
        dm.bootstrap_fleet(DeviceType(token="thermo", name="Thermometer"), n)
        dev = np.arange(n, dtype=np.int64)
        for j in range(warm.shape[0]):
            em.telemetry.append_values(dev, warm[j],
                                       np.full(n, tick_s * j))
        engine = rt.api("rule-processing").engine(tenant)
        sink = engine.session or engine.pool_slot
        deadline = time.monotonic() + READY_TIMEOUT_S
        while not sink.ready:
            if time.monotonic() > deadline:
                raise TimeoutError(f"scoring warm-up not done in "
                                   f"{READY_TIMEOUT_S} s")
            await asyncio.sleep(0.01)
        # the harness's weights; a streaming ring reseeds from the store
        # under them, and the warm history entered the store directly
        engine.swap_model_params(params)
        sink.reload_history()
        receiver = rt.api("event-sources").engine(tenant).receiver("default")
        return Deployment(rt, engine, sink, em, receiver, tenant)
    except BaseException:
        await rt.stop()
        raise
