"""The bench's process-split deployment (`bench.py --split`) in the port.

    python -m sitewhere_tpu_torch.tools.split [--devices N]
        [--model lstm-stream|lstm] [--cpu]

Two processes, as the bench splits them (`bench.py:338-600`):

- the parent (this process) runs the broker — an in-proc `EventBus`
  behind a `BusServer` — the event-sources service, whose tenant queue
  receiver takes the simulator's SWB1 ticks, and the meter: a consumer
  of the tenant's scored-events topic on the broker's own bus;
- the child, a fresh interpreter (`subprocess.Popen`, never a fork of a
  process that may have touched CUDA), runs device-management,
  inbound-processing, event-management, device-state and
  rule-processing on a `RemoteEventBus` attached to that broker. Every
  decoded record and every scored batch crosses a real socket.

The child owns the tenant definition: its `add_tenant` broadcast on the
shared bus spins the parent's event-sources engine too. It registers
the fleet, writes W+4 ticks of warm history into its store, reseeds the
scoring ring and answers on stdin, one line each on stdout:
`READY` once warm; `RESET` (zero its latency, stage and dispatch
counters and K1's launch count) → `OK`; `STATS` → one JSON object;
`SAMPLE <dir> <n>` (the tenant's params as a checkpoint under `<dir>`
and the store's windows of `n` seeded devices in `<dir>/windows.npz`) →
`OK`; `EXIT` (or end of input) stops it. Nothing else goes to stdout.

Monotonic clocks are per process, so no stamp crosses the boundary:
events/s is the parent's (first submit → last scored record read back
over the broker); the e2e latency is the child's, from wire decode
(the wire client re-stamps a batch's ingest time on arrival) to scored.
The child's device comes from `InstanceSettings.device`: the CUDA card
by default, the CPU when `SplitConfig.device` names it. The tenant is
the bench's pipeline tenant (`tools/pipeline.py`): threshold 6.0, 2 ms
batch window, one fleet-sized bucket, ring capacity = the fleet, 8
flushes in flight, history 256; `lstm-stream` through the megabatch
pool, or `lstm` (windowed) on a dedicated session, which launches K1.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

import numpy as np

from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from sitewhere_tpu_torch.tools.pipeline import (
    HISTORY,
    TENANT,
    THRESHOLD,
    TICK_S,
    scored_table,
)

# the bench pipeline's batch window, flushes in flight, and the paced
# window's share of the burst's events/s
BATCH_WINDOW_MS, MAX_INFLIGHT, PACED_FRACTION = 2.0, 8, 0.5
READY_TIMEOUT_S = 600.0
CMD_TIMEOUT_S = 60.0
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass
class SplitConfig:
    devices: int = 32768
    # lstm-stream scores through the megabatch pool, lstm (windowed) on
    # a dedicated session
    model: str = "lstm-stream"
    window: int = 64
    model_config: dict = field(default_factory=dict)
    seed: int = 0
    burst_ticks: int = 6
    anomaly_at: int = 3
    paced_ticks: int = 24
    # the child's torch device: None is the CUDA card
    device: Optional[str] = None
    # a CheckpointStore root holding `bench/<model>` params to install
    # before the ring is seeded (seeded weights from a caller)
    checkpoint: Optional[str] = None
    timeout_s: float = 300.0
    # the broker the child attaches to (set by the parent)
    broker_port: int = 0

    @property
    def pooled(self) -> bool:
        return self.model == "lstm-stream"


def tenant_sections(cfg: SplitConfig) -> dict:
    """The child's tenant: the bench pipeline's sections."""
    return {
        "egress": {"fused": True, "lanes": 1, "autotune": False},
        "event-management": {"history": HISTORY},
        "rule-processing": {
            "model": cfg.model,
            "model_config": {"window": cfg.window, **cfg.model_config},
            "threshold": THRESHOLD,
            "batch_window_ms": BATCH_WINDOW_MS,
            "buckets": [cfg.devices],
            "capacity": cfg.devices,
            "max_inflight": MAX_INFLIGHT,
            "readback": "full",
            "shared": False,
            "megabatch": {"enabled": cfg.pooled},
        },
    }


def instance_settings(**kw):
    """Both processes' settings: the bench's shed policy (reject at
    ingress only), every trace sampled for the stage spans."""
    from sitewhere_tpu_torch.config import InstanceSettings

    return InstanceSettings(instance_id="split-bench", trace_sample=1,
                            flow_degrade_at=10.0, flow_defer_at=10.0, **kw)


def warm_ticks(cfg: SplitConfig):
    """The W+4 ticks of warm history the child writes into its store."""
    sim = DeviceSimulator(SimConfig(num_devices=cfg.devices, seed=cfg.seed),
                          tenant_id=TENANT)
    return [sim.tick(t=TICK_S * k)[0] for k in range(cfg.window + 4)]


def traffic(cfg: SplitConfig) -> list:
    """The parent's ticks after the warm history: `burst_ticks` then
    `paced_ticks`, tick `anomaly_at` with 5% of devices spiking by 12
    sigma: [(batch, truth)]."""
    base = SimConfig(num_devices=cfg.devices, seed=cfg.seed + 1)
    spike = SimConfig(num_devices=cfg.devices, seed=cfg.seed + 1,
                      anomaly_rate=0.05, anomaly_magnitude=12.0)
    sim = DeviceSimulator(base, tenant_id=TENANT)
    t0 = TICK_S * (cfg.window + 4)
    out = []
    for k in range(cfg.burst_ticks + cfg.paced_ticks):
        sim.cfg = spike if k == cfg.anomaly_at else base
        out.append(sim.tick(t=t0 + TICK_S * k))
    return out


# -- the child: the scorer process --------------------------------------------

async def child_main(cfg: SplitConfig) -> None:
    # seconds of each set-up step, from here
    setup, t0 = {}, time.perf_counter()
    mark = lambda step: setup.__setitem__(  # noqa: E731
        step, time.perf_counter() - t0)
    from sitewhere_tpu_torch.config import TenantConfig
    from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
    from sitewhere_tpu_torch.domain.model import DeviceType
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.kernel.wire import RemoteEventBus
    from sitewhere_tpu_torch.ops import lstm_kernel
    from sitewhere_tpu_torch.services import (
        DeviceManagementService,
        DeviceStateService,
        EventManagementService,
        InboundProcessingService,
        RuleProcessingService,
    )
    from sitewhere_tpu_torch.training.checkpoint import CheckpointStore

    mark("imports")
    bus = RemoteEventBus("127.0.0.1", cfg.broker_port)
    rt = ServiceRuntime(instance_settings(device=cfg.device), bus=bus)
    for cls in (DeviceManagementService, InboundProcessingService,
                EventManagementService, DeviceStateService,
                RuleProcessingService):
        rt.add_service(cls(rt))
    await rt.start()
    mark("runtime")
    await rt.add_tenant(TenantConfig(tenant_id=TENANT,
                                     sections=tenant_sections(cfg)),
                        timeout=READY_TIMEOUT_S)
    mark("tenant")
    dm = rt.api("device-management").management(TENANT)
    dm.bootstrap_fleet(DeviceType(token="thermo", name="Thermometer"),
                       cfg.devices)
    mark("fleet")
    em = rt.api("event-management").management(TENANT)
    for batch in warm_ticks(cfg):
        em.telemetry.append_measurements(batch)
    mark("history")
    eng = rt.api("rule-processing").engine(TENANT)
    sink = eng.session or eng.pool_slot
    device = rt.services["rule-processing"].device
    while not sink.ready:
        await asyncio.sleep(0.05)
    if cfg.checkpoint:
        params, _ = CheckpointStore(cfg.checkpoint).load(TENANT, cfg.model)
        sink.swap_params(params_from_numpy(params, device))
    # the warm history entered the store directly: reseed the ring
    sink.reload_history()
    mark("ready")
    print("READY", flush=True)

    stages = {nm: getattr(sink, f"stage_{nm}")
              for nm in ("admit", "batch", "device", "sink")}
    dispatches = rt.metrics.counter("scoring.dispatches")
    d0 = dispatches.value
    loop = asyncio.get_running_loop()
    while True:
        line = await loop.run_in_executor(None, sys.stdin.readline)
        cmd, *rest = line.split() or ["EXIT"]
        if cmd == "RESET":
            sink.latency.reset()
            for h in stages.values():
                h.reset()
            d0 = dispatches.value
            lstm_kernel.launches = 0
            print("OK", flush=True)
        elif cmd == "STATS":
            q = sink.latency.quantile
            print(json.dumps({
                "scored": sink.latency.count,
                "e2e_p50_ms": 1e3 * q(0.5),
                "e2e_p99_ms": 1e3 * q(0.99),
                "breakdown": {nm: {"p50_ms": 1e3 * h.quantile(0.5),
                                   "p99_ms": 1e3 * h.quantile(0.99)}
                              for nm, h in stages.items()},
                "dispatches": int(dispatches.value - d0),
                "kernel_launches": lstm_kernel.launches,
                "inflight": sink.inflight,
                "wire_stats": bus.wire_stats(),
                "linger_batches": rt.metrics.gauge(
                    "wire.linger_batches").value,
                "device": str(device),
                "setup_s": setup,
                "stages": {stage: {"mean_ms": row["mean_ms"],
                                   "p50_ms": row["p50_ms"],
                                   "spans": row["count"]}
                           for stage, row in
                           rt.tracer.stage_summary().items()},
            }), flush=True)
        elif cmd == "SAMPLE":
            out_dir, n = rest[0], int(rest[1])
            params = (eng.pool_slot.pool.stack.get_params(TENANT)
                      if eng.pool_slot is not None else eng.session.params)
            CheckpointStore(out_dir).save(TENANT, cfg.model,
                                          params_to_numpy(params))
            devices = np.sort(np.random.default_rng(cfg.seed + 7).choice(
                cfg.devices, min(n, cfg.devices), replace=False))
            x, valid = em.telemetry.window(devices, cfg.window)
            np.savez(os.path.join(out_dir, "windows.npz"), devices=devices,
                     x=x, valid=valid)
            print("OK", flush=True)
        else:  # EXIT / end of input
            break
    await rt.stop()


def _child_entry() -> None:
    asyncio.run(child_main(SplitConfig(**json.loads(sys.argv[1]))))


_CHILD_SRC = ("import sys; sys.path.insert(0, sys.argv[2]); "
              "from sitewhere_tpu_torch.tools.split import _child_entry; "
              "_child_entry()")


# -- the parent: broker, ingress, meter ---------------------------------------

class ChildDied(RuntimeError):
    """The scorer process exited or stopped answering."""


class Split:
    """The running deployment: `await start()`, then `submit`,
    `collect`, `child_cmd`; `await stop()` at the end."""

    def __init__(self, cfg: SplitConfig):
        self.cfg = cfg
        self.rt = self.broker = self.scored = self.proc = self._stderr = None

    async def start(self) -> None:
        from sitewhere_tpu_torch.kernel.bus import EventBus, TopicNaming
        from sitewhere_tpu_torch.kernel.service import ServiceRuntime
        from sitewhere_tpu_torch.kernel.wire import BusServer
        from sitewhere_tpu_torch.services import EventSourcesService

        # the runtime owns the in-proc bus's lifecycle; the broker wraps it
        self.bus = EventBus(default_partitions=4)
        self.rt = ServiceRuntime(instance_settings(), bus=self.bus)
        self.rt.add_service(EventSourcesService(self.rt))
        await self.rt.start()
        self.broker = BusServer(self.bus)
        await self.broker.start()
        self.scored = self.bus.subscribe(
            self.rt.naming.tenant_topic(TENANT, TopicNaming.SCORED_EVENTS),
            group="split-meter")
        child_cfg = {**asdict(self.cfg), "broker_port": self.broker.port}
        self._stderr = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-u", "-c", _CHILD_SRC, json.dumps(child_cfg),
             REPO], stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self._stderr, text=True)
        line = await self._line(READY_TIMEOUT_S)
        if line != "READY":
            raise ChildDied(f"the scorer said {line!r}{self._tail()}")
        # our event-sources engine spun from the child's broadcast
        eng = await self.rt.wait_for_engine("event-sources", TENANT,
                                            timeout=60.0)
        self.receiver = eng.receiver("default")

    def _tail(self, n: int = 4000) -> str:
        if self._stderr is None:
            return ""
        self._stderr.flush()
        self._stderr.seek(0)
        text = self._stderr.read()
        return f"; the scorer's stderr ends:\n{text[-n:]}"

    async def _line(self, timeout: float) -> str:
        loop = asyncio.get_running_loop()
        try:
            line = await asyncio.wait_for(
                loop.run_in_executor(None, self.proc.stdout.readline),
                timeout)
        except asyncio.TimeoutError:
            self.proc.kill()
            raise ChildDied(f"the scorer did not answer in {timeout} s"
                            f"{self._tail()}") from None
        if not line:
            self.proc.wait(timeout=30)
            raise ChildDied(f"the scorer exited with {self.proc.returncode}"
                            f"{self._tail()}")
        return line.strip()

    async def child_cmd(self, cmd: str, timeout: float = CMD_TIMEOUT_S) -> str:
        if self.proc.poll() is not None:
            raise ChildDied(f"the scorer exited with {self.proc.returncode}"
                            f"{self._tail()}")
        self.proc.stdin.write(cmd + "\n")
        self.proc.stdin.flush()
        return await self._line(timeout)

    async def ok(self, cmd: str) -> None:
        answer = await self.child_cmd(cmd)
        if answer != "OK":
            raise ChildDied(f"{cmd.split()[0]}: the scorer said {answer!r}")

    async def stats(self) -> dict:
        return json.loads(await self.child_cmd("STATS"))

    async def submit(self, payload: bytes) -> None:
        if not await self.receiver.submit(payload):
            raise AssertionError("split: a tick was shed at ingress")

    async def collect(self, want: int) -> tuple[list, float]:
        """Scored batches read back over the broker until `want` events
        arrived: (batches in arrival order, monotonic time of the last)."""
        got, n, t_last = [], 0, time.monotonic()
        deadline = time.monotonic() + self.cfg.timeout_s
        while n < want:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"split: {n} of {want} scored events in "
                                   f"{self.cfg.timeout_s} s{self._tail()}")
            if self.proc.poll() is not None:
                raise ChildDied(f"the scorer exited with "
                                f"{self.proc.returncode}{self._tail()}")
            for rec in await self.scored.poll(max_records=512,
                                              timeout=min(left, 0.5)):
                got.append(rec.value)
                n += len(rec.value)
                t_last = time.monotonic()
        return got, t_last

    async def drained(self, timeout: float = 30.0) -> dict:
        """Wait until every consumer group of the tenant has committed
        through its topics' end offsets; returns the lags (all 0)."""
        deadline = time.monotonic() + timeout
        while True:
            lags = {g: dict(v) for g, v in self.bus.group_lags().items()
                    if g.startswith(f"{TENANT}.")}
            if lags and not any(n for v in lags.values() for n in v.values()):
                return lags
            if time.monotonic() > deadline:
                raise AssertionError(f"split: committed offsets short of the "
                                     f"end after {timeout} s: {lags}")
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        try:
            if self.proc is not None and self.proc.poll() is None:
                try:
                    self.proc.stdin.write("EXIT\n")
                    self.proc.stdin.flush()
                except (BrokenPipeError, ValueError):
                    pass
                try:
                    await asyncio.get_running_loop().run_in_executor(
                        None, self.proc.wait, 60)
                except subprocess.TimeoutExpired:
                    self.proc.kill()
                    self.proc.wait()
        finally:
            if self.scored is not None:
                self.scored.close()
            if self.broker is not None:
                await self.broker.stop()
            if self.rt is not None:
                await self.rt.stop()
            if self._stderr is not None:
                self._stderr.close()


def check_once(label: str, ticks, batches) -> dict:
    """Every event of `ticks` scored exactly once; returns the table."""
    table = scored_table(batches)
    keys = {(d, ts) for batch in ticks
            for d, ts in zip(batch.device_index.tolist(), batch.ts.tolist())}
    twice = sum(1 for v in table.values() if v[2] > 1)
    n = sum(map(len, batches))
    if set(table) != keys or twice or n != len(keys):
        raise AssertionError(f"{label}: {len(table)} scored keys for "
                             f"{len(keys)} events, {twice} scored twice, "
                             f"{n} records")
    return table


async def run(cfg: SplitConfig, sample: int = 0,
              sample_dir: Optional[str] = None) -> tuple[dict, dict]:
    """The bench's split sequence: a burst of `burst_ticks` fleet ticks,
    then `paced_ticks` at PACED_FRACTION of the burst's events/s.
    Every event must be scored exactly once and every consumer group
    of the tenant drained to the end offsets. With `sample` and
    `sample_dir`, the child writes its params and `sample` devices'
    windows there (before the traffic for a pooled model, whose
    reference steps over it; after the burst for a windowed one).
    Returns (the report, {"ticks": [(batch, truth)], "burst": scored
    batches, "paced": scored batches})."""
    plan = traffic(cfg)
    payloads = [batch.encode() for batch, _ in plan]
    burst, paced = payloads[:cfg.burst_ticks], payloads[cfg.burst_ticks:]
    n = cfg.devices
    split = Split(cfg)
    t_setup = time.perf_counter()
    try:
        await split.start()
        setup_s = time.perf_counter() - t_setup
        if sample and cfg.pooled:
            await split.ok(f"SAMPLE {sample_dir} {sample}")
        await split.ok("RESET")
        t0 = time.monotonic()
        for payload in burst:
            await split.submit(payload)
        got_burst, t_last = await split.collect(len(burst) * n)
        rate = len(burst) * n / max(t_last - t0, 1e-9)
        burst_stats = await split.stats()
        if sample and not cfg.pooled:
            await split.ok(f"SAMPLE {sample_dir} {sample}")
        await split.ok("RESET")
        interval = n / max(PACED_FRACTION * rate, 1.0)
        next_t = time.monotonic()
        for payload in paced:
            await split.submit(payload)
            next_t += interval
            await asyncio.sleep(max(0.0, next_t - time.monotonic()))
        got_paced, _ = await split.collect(len(paced) * n)
        paced_stats = await split.stats()
        check_once("split", [b for b, _ in plan], got_burst + got_paced)
        lags = await split.drained()
    finally:
        await split.stop()
    report = {
        "deployment": "split (broker+ingest | scorer process)",
        "model": cfg.model, "pooled": cfg.pooled, "devices": n,
        "events": len(plan) * n, "setup_s": setup_s,
        "events_per_s": rate,
        "burst": burst_stats, "paced": {"interval_ms": 1e3 * interval,
                                        **paced_stats},
        "dispatches": burst_stats["dispatches"] + paced_stats["dispatches"],
        "kernel_launches": (burst_stats["kernel_launches"]
                            + paced_stats["kernel_launches"]),
        "groups_drained": sorted(lags),
        "child_exit": split.proc.returncode,
    }
    if split.proc.returncode != 0:
        raise ChildDied(f"the scorer exited with {split.proc.returncode}")
    return report, {"ticks": plan, "burst": got_burst, "paced": got_paced}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sitewhere_tpu_torch.tools.split")
    parser.add_argument("--devices", type=int, default=32768)
    parser.add_argument("--model", default="lstm-stream",
                        choices=["lstm-stream", "lstm"])
    parser.add_argument("--cpu", action="store_true",
                        help="score on the CPU instead of the CUDA card")
    args = parser.parse_args(argv)
    cfg = SplitConfig(devices=args.devices, model=args.model,
                      device="cpu" if args.cpu else None)
    report, _ = asyncio.run(run(cfg))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
