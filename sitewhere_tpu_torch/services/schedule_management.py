"""schedule-management service (reference: service-schedule-management,
[SURVEY.md §2.2]): schedules for command invocations and batch
operations. The reference uses Quartz; here a light asyncio scheduler
with the same trigger types:

- `simple`: fixed interval with optional repeat count
  trigger_configuration: {"repeat_interval_s": N, "repeat_count": -1}
- `cron`: 5-field cron expression (min hour dom month dow)
  trigger_configuration: {"expression": "*/5 * * * *"}

Job types (reference parity + north star):
- `command-invocation`: {"device_id", "command_id", "parameters"}
- `batch-command-invocation`: {"device_ids"|"group_token", "command_id", ...}
- `train-model`: {"model", "steps", ...}  (nightly retrain trigger)
"""

from __future__ import annotations

import asyncio
import logging
import time
from datetime import datetime
from typing import Optional

from sitewhere_tpu_torch.config import TenantConfig
from sitewhere_tpu_torch.domain.events import DeviceCommandInvocation
from sitewhere_tpu_torch.domain.model import Schedule, ScheduledJob
from sitewhere_tpu_torch.kernel.lifecycle import BackgroundTaskComponent
from sitewhere_tpu_torch.kernel.service import Service, TenantEngine
from sitewhere_tpu_torch.persistence.memory import InMemoryScheduleManagement

logger = logging.getLogger(__name__)


def cron_matches(expression: str, dt: datetime) -> bool:
    """5-field cron match (minute hour dom month dow); supports
    `*`, lists `a,b`, ranges `a-b`, steps `*/n` and `a-b/n`."""

    def field_matches(spec: str, value: int, lo: int, hi: int) -> bool:
        for part in spec.split(","):
            step = 1
            if "/" in part:
                part, step_s = part.split("/", 1)
                step = int(step_s)
            if part in ("*", ""):
                lo2, hi2 = lo, hi
            elif "-" in part:
                a, b = part.split("-", 1)
                lo2, hi2 = int(a), int(b)
            else:
                lo2 = hi2 = int(part)
            if lo2 <= value <= hi2 and (value - lo2) % step == 0:
                return True
        return False

    fields = expression.split()
    if len(fields) != 5:
        raise ValueError(f"cron expression needs 5 fields: {expression!r}")
    minute, hour, dom, month, dow = fields
    # POSIX cron day-of-week: 0 (or 7) = Sunday ... 6 = Saturday
    cron_dow = (dt.weekday() + 1) % 7
    dow_ok = field_matches(dow, cron_dow, 0, 7) or (
        cron_dow == 0 and field_matches(dow, 7, 0, 7))
    return (field_matches(minute, dt.minute, 0, 59)
            and field_matches(hour, dt.hour, 0, 23)
            and field_matches(dom, dt.day, 1, 31)
            and field_matches(month, dt.month, 1, 12)
            and dow_ok)


class ScheduleManagementEngine(TenantEngine):
    def __init__(self, service: "ScheduleManagementService", tenant: TenantConfig):
        super().__init__(service, tenant)
        cfg = tenant.section("schedule-management", {})
        self.spi = InMemoryScheduleManagement()
        self.tick_s = cfg.get("tick_s", 1.0)
        # schedule_id -> (next_fire_monotonic, fires_so_far)
        self._state: dict[str, tuple[float, int]] = {}
        self.manager = ScheduleManager(self)
        self.add_child(self.manager)

    def __getattr__(self, name):
        return getattr(self.spi, name)


class ScheduleManager(BackgroundTaskComponent):
    """(reference: ScheduleManager + Quartz jobs)"""

    def __init__(self, engine: ScheduleManagementEngine):
        super().__init__("schedule-manager")
        self.engine = engine

    async def _run(self) -> None:
        engine = self.engine
        fired = engine.runtime.metrics.counter("schedule.jobs_fired")
        while True:
            now = time.time()
            for job in engine.spi.list_scheduled_jobs():
                if job.job_state != "active":
                    continue
                schedule = engine.spi.get_schedule(job.schedule_id)
                if schedule is None or not self._due(schedule, now):
                    continue
                try:
                    await self._fire(job)
                    fired.inc()
                except Exception:  # noqa: BLE001 - job errors isolated
                    logger.exception("scheduled job %s failed", job.id)
            await asyncio.sleep(engine.tick_s)

    def _due(self, schedule: Schedule, now: float) -> bool:
        engine = self.engine
        if schedule.start_date and now < schedule.start_date:
            return False
        if schedule.end_date and now > schedule.end_date:
            return False
        state = engine._state.get(schedule.id)
        if schedule.trigger_type == "simple":
            interval = schedule.trigger_configuration.get("repeat_interval_s", 60)
            repeat = schedule.trigger_configuration.get("repeat_count", -1)
            if state is None:
                engine._state[schedule.id] = (now + interval, 1)
                return True  # first fire immediately (Quartz default)
            next_fire, count = state
            if repeat >= 0 and count > repeat:
                return False
            if now >= next_fire:
                engine._state[schedule.id] = (next_fire + interval, count + 1)
                return True
            return False
        if schedule.trigger_type == "cron":
            expr = schedule.trigger_configuration.get("expression", "* * * * *")
            minute_bucket = int(now // 60)
            if state is not None and state[0] == minute_bucket:
                return False  # already fired this minute
            if cron_matches(expr, datetime.fromtimestamp(now)):
                engine._state[schedule.id] = (minute_bucket,
                                              (state[1] + 1) if state else 1)
                return True
            return False
        return False

    async def _fire(self, job: ScheduledJob) -> None:
        engine = self.engine
        runtime = engine.runtime
        tenant_id = engine.tenant_id
        cfg = job.configuration
        if job.job_type == "command-invocation":
            em = await runtime.wait_for_engine("event-management", tenant_id)
            dm = await runtime.wait_for_engine("device-management", tenant_id)
            device = dm.get_device(cfg["device_id"])
            if device is None:
                return
            assignments = dm.get_active_assignments_for_device(device.id)
            await em.add_command_invocations([DeviceCommandInvocation(
                device_id=device.id,
                assignment_id=assignments[0].id if assignments else "",
                initiator="schedule", initiator_id=job.id,
                command_id=cfg["command_id"],
                parameter_values=cfg.get("parameters", {}))])
        elif job.job_type == "batch-command-invocation":
            batch = await runtime.wait_for_engine("batch-operations", tenant_id)
            device_ids = cfg.get("device_ids")
            if not device_ids and cfg.get("group_token"):
                dm = await runtime.wait_for_engine("device-management", tenant_id)
                group = dm.get_device_group_by_token(cfg["group_token"])
                if group is not None:
                    device_ids = [d.id for d in dm.expand_group_devices(group.id)]
            if device_ids:
                await batch.submit_command_operation(
                    device_ids, cfg["command_id"],
                    cfg.get("parameters"), initiator="schedule",
                    initiator_id=job.id)
        elif job.job_type == "train-model":
            batch = await runtime.wait_for_engine("batch-operations", tenant_id)
            await batch.submit_training_operation(
                cfg.get("model"), steps=cfg.get("steps", 200),
                batch_size=cfg.get("batch_size", 1024),
                learning_rate=cfg.get("lr", 1e-3))
        else:
            logger.warning("unknown job type %r", job.job_type)


class ScheduleManagementService(Service):
    identifier = "schedule-management"
    multitenant = True

    def create_tenant_engine(self, tenant: TenantConfig) -> ScheduleManagementEngine:
        return ScheduleManagementEngine(self, tenant)

    def schedules(self, tenant_id: str) -> ScheduleManagementEngine:
        return self.engine(tenant_id)  # type: ignore[return-value]
