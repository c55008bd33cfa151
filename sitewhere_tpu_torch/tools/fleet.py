"""The bench's fleet deployment (`bench.py --workers N`) in the port.

    python -m sitewhere_tpu_torch.tools.fleet [--workers N] [--devices N]
        [--model lstm|lstm-stream] [--zombie-drill] [--cpu]

The topology of `bench.py:617-1220` (`run_fleet_bench`):

- this process is the bus tier, the ingress and the control plane: an
  in-proc `EventBus` behind a `BusServer`, the event-sources service
  with a queue receiver for every tenant, the `FleetController` (with
  the `FleetObserver` and, over the controller's telemetry history, the
  predictive planner) and an OS-process spawner, and the simulator;
- N worker processes, each a fresh interpreter
  (`python -m sitewhere_tpu_torch.fleet.worker_main`, never a fork of a
  process that holds a CUDA context), attach over the wire and host
  device-management, inbound-processing, event-management, device-state
  and rule-processing for the tenants that placement gives them, on the
  CUDA card (the CPU with `--cpu`).

Tenant registry state reaches the workers by bus replay alone (a
seeding runtime with registry replication registers every tenant's
fleet onto the broker's bus), so the fleet shares no filesystem. Each
tenant has the bench pipeline's sections (`tools/split.py`): windowed
`lstm` on a dedicated session (K1 in every worker), or `lstm-stream`
through the pool with `--model lstm-stream`.

The sequence: the tenants are placed while the workers start (the
first worker to join adopts them all, and the next one's placement moves
some that are still starting, as in the bench); W+4 warm ticks of every
tenant through the whole path; a burst of `BURST_TICKS` (one with anomalies), each event
scored exactly once and read back over the broker (the aggregate
events/s); each worker's scoring dispatches and K1 launches over the
burst, read from its `ApiServer` (`stats`); then the kill drill (two
workers or more): a flood of every tenant with a SIGKILL of the busiest
worker 40% in. It counts the seconds to detect the death, to reconverge
without the victim and to take the replacement in, the accepted events
lost (must be 0), the decoded backlog after the drain (must be 0) and
every tenant consumer group committed through the end offsets.
`--zombie-drill` then SIGSTOPs the busiest worker past the death bound
and SIGCONTs it mid-reassignment: its writes must be fenced, nothing
lost, and a flood after reconvergence scored exactly once. A worker that
dies unasked fails the run with the tail of its stderr (a clean exit is
a retirement: a worker declared dead while only stalled leaves once it
reads its exclusion, and the controller has replaced it). The report is
one JSON object.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass
from typing import Optional

from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from sitewhere_tpu_torch.tools.pipeline import TICK_S
from sitewhere_tpu_torch.tools.split import (
    REPO,
    SplitConfig,
    check_once,
    tenant_sections,
)

INSTANCE = "fleet-bench"
TENANTS = 4
# the tenants' window (pipeline-window's), the burst's ticks and the one
# of them with anomalies
WINDOW = 64
BURST_TICKS, ANOMALY_AT = 6, 3
# the bench's fleet timings (`bench.py:657-660`, `:696`): controller
# tick, death bound, worker heartbeat; the kill drill's flood seconds and
# the share of it at which the SIGKILL lands; the waits' bounds
INTERVAL_S, DEAD_AFTER_S, HEARTBEAT_S = 0.25, 6.0, 0.25
FLOOD_S, KILL_AT = 6.0, 0.4
READY_TIMEOUT_S, DRAIN_TIMEOUT_S = 600.0, 180.0
# the run's steps at INFO, the controller's placement trail beside them
logger = logging.getLogger(__name__)


@dataclass
class FleetConfig:
    workers: int = 2
    devices: int = 32768       # over TENANTS tenants
    # lstm (windowed) on a dedicated session, or lstm-stream in the pool
    model: str = "lstm"
    zombie: bool = False
    # the workers' torch device: None is the CUDA card
    device: Optional[str] = None

    @property
    def per_tenant(self) -> int:
        return max(self.devices // TENANTS, 1)

    @property
    def tenant_ids(self) -> list[str]:
        return [f"bench{i}" for i in range(TENANTS)]


class WorkerDied(RuntimeError):
    """A fleet worker process exited that the run did not stop."""


def warm_and_burst(cfg: FleetConfig) -> dict:
    """Every tenant's W+4 warm ticks then its burst ticks, tick
    `ANOMALY_AT` of the burst with 5% of devices spiking by 12 sigma:
    {"ticks": {tenant: [(batch, truth)]}, "sims": {tenant: its
    simulator, for the floods after}}."""
    ticks, sims = {}, {}
    for i, tid in enumerate(cfg.tenant_ids):
        base = SimConfig(num_devices=cfg.per_tenant, seed=i)
        spike = SimConfig(num_devices=cfg.per_tenant, seed=i,
                          anomaly_rate=0.05, anomaly_magnitude=12.0)
        sim = sims[tid] = DeviceSimulator(base, tenant_id=tid)
        warm = WINDOW + 4
        out = []
        for k in range(warm + BURST_TICKS):
            sim.cfg = spike if k == warm + ANOMALY_AT else base
            out.append(sim.tick(t=TICK_S * k))
        sim.cfg = base
        ticks[tid] = out
    return {"ticks": ticks, "sims": sims}


class Fleet:
    """The running deployment: `await start()`, then `send`, `flood`,
    `caught_up`, `drained`, `worker_stats`; `await stop()` at the end."""

    def __init__(self, cfg: FleetConfig):
        self.cfg = cfg
        self.rt = self.broker = self.controller = self.bus = None
        self.procs: dict[str, subprocess.Popen] = {}
        self.stderr: dict[str, object] = {}
        self.api_ports: dict[str, int] = {}
        self.expected_dead: set[str] = set()
        self.meters: dict = {}
        self.sent = {tid: 0 for tid in cfg.tenant_ids}
        self.scored = {tid: 0 for tid in cfg.tenant_ids}
        self.keep: Optional[dict] = None
        self.setup_s: dict[str, float] = {}
        self._wids = iter(range(10_000))
        self._dir = None
        self.closing = False

    # -- workers ----------------------------------------------------------

    def retired(self) -> list[str]:
        return sorted(w for w, p in self.procs.items()
                      if p.poll() == 0 and w not in self.expected_dead)

    def _spawn(self) -> Optional[str]:
        if self.closing:
            return None  # the workers leaving at the end are not replaced
        cfg = self.cfg
        wid = f"w{next(self._wids)}"
        wcfg = {
            "worker_id": wid, "host": "127.0.0.1", "port": self.broker.port,
            "instance_id": INSTANCE, "force_cpu": cfg.device == "cpu",
            "log_level": "WARNING", "api_port": 0,
            "settings": {
                "engine_ready_timeout_s": READY_TIMEOUT_S,
                "fleet_heartbeat_s": HEARTBEAT_S,
                "flow_degrade_at": 10.0, "flow_defer_at": 10.0,
                # worker-LOCAL scratch (registry WAL + snapshots), one
                # private dir a worker: adoption state comes from bus
                # replay (hermetic fleet)
                "data_dir": os.path.join(self._dir, wid),
            },
        }
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.stderr[wid] = tempfile.TemporaryFile(mode="w+")
        proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "sitewhere_tpu_torch.fleet.worker_main",
             json.dumps(wcfg)], stdout=subprocess.PIPE,
            stderr=self.stderr[wid], text=True, env=env, cwd=REPO)
        self.procs[wid] = proc
        threading.Thread(target=self._read_stdout, args=(wid, proc),
                         daemon=True).start()
        return wid

    def _read_stdout(self, wid: str, proc: subprocess.Popen) -> None:
        for line in proc.stdout:
            parts = line.split()
            if parts[2:3] == ["api-port"]:
                self.api_ports[wid] = int(parts[3])

    def tail(self, wid: str, n: int = 4000) -> str:
        f = self.stderr[wid]
        f.flush()
        f.seek(0)
        return f.read()[-n:]

    def check_workers(self) -> None:
        """Raise if a worker died unasked. Exit 0 is a retirement, not a
        death: a worker declared dead while it was only stalled (SIGSTOP,
        or a loop held past the bound on a loaded host) reads its
        exclusion, owns nothing and leaves cleanly; the controller has
        already replaced it."""
        for wid, proc in self.procs.items():
            if proc.poll() not in (None, 0) and wid not in self.expected_dead:
                raise WorkerDied(f"fleet worker {wid} exited with "
                                 f"{proc.returncode}; its stderr ends:\n"
                                 f"{self.tail(wid)}")

    def diagnose(self) -> str:
        """What a stuck run looks like: counts, placement, the tenant
        groups still lagging and each worker's stderr tail."""
        snap = self.controller.snapshot() if self.controller else {}
        lags = {g: dict(v) for g, v in self.bus.group_lags().items()
                if any(v.values())} if self.bus is not None else {}
        prefixes = tuple(f"{tid}." for tid in self.cfg.tenant_ids)
        # every tenant group: its members (owner, partitions held) and the
        # records it committed; every tenant topic's records
        members = {g: ([(m.owner, len(m._assignment)) for m in st.members],
                       sum(st.committed.values()))
                   for g, st in self.bus._groups.items()
                   if g.startswith(prefixes)} if self.bus is not None else {}
        ends = {t.split(".tenant.", 1)[1]: sum(self.bus.end_offsets(t))
                for t in self.bus._topics
                if ".tenant." in t} if self.bus is not None else {}
        tails = "".join(f"\n--- {wid} (exit {p.poll()}) stderr:\n"
                        f"{self.tail(wid, 1500)}"
                        for wid, p in self.procs.items())
        return (f"; sent {self.sent} scored {self.scored}; epoch "
                f"{snap.get('epoch')} owners {snap.get('owners')} workers "
                f"{ {w: (r['owned'], r['pending'], r['ready']) for w, r in snap.get('workers', {}).items()} }"
                f"; lagging groups {lags}; tenant groups (members, "
                f"committed) {members}; topic ends {ends}{tails}")

    def live(self) -> list[str]:
        return [w for w, p in self.procs.items() if p.poll() is None]

    async def worker_stats(self) -> dict:
        """Each live worker's `stats` (dispatches, K1 launches, owned)."""
        from sitewhere_tpu_torch.kernel.wire import WireClient

        out = {}
        for wid in self.live():
            port = self.api_ports.get(wid)
            if port is None:
                continue
            client = WireClient("127.0.0.1", port)
            try:
                await client.connect()
                out[wid] = await asyncio.wait_for(client.call("stats"), 30.0)
            finally:
                client.close()
        return out

    # -- set-up -----------------------------------------------------------

    async def start(self) -> None:
        from sitewhere_tpu_torch.config import InstanceSettings, TenantConfig
        from sitewhere_tpu_torch.domain.model import DeviceType
        from sitewhere_tpu_torch.fleet import AutoscalerPolicy, FleetController
        from sitewhere_tpu_torch.kernel.bus import EventBus, TopicNaming
        from sitewhere_tpu_torch.kernel.service import ServiceRuntime
        from sitewhere_tpu_torch.kernel.wire import BusServer
        from sitewhere_tpu_torch.services import (
            DeviceManagementService,
            EventSourcesService,
        )

        cfg = self.cfg
        t0 = time.perf_counter()
        mark = lambda step: self.setup_s.__setitem__(  # noqa: E731
            step, time.perf_counter() - t0)
        prebuild(cfg)
        mark("kernels")
        self._dir = tempfile.mkdtemp(prefix="swx-fleet-")
        # deep retention: a reassignment window must never trim records
        # the kill drill still owes the new owner
        self.bus = EventBus(default_partitions=4, retention=65536)
        self.rt = ServiceRuntime(InstanceSettings(
            instance_id=INSTANCE, bus_retention=65536,
            engine_ready_timeout_s=READY_TIMEOUT_S,
            fleet_interval_s=INTERVAL_S,
            fleet_dead_after_s=DEAD_AFTER_S,
            flow_degrade_at=10.0, flow_defer_at=10.0, device=cfg.device,
            data_dir=os.path.join(self._dir, "controller")), bus=self.bus)
        self.rt.add_service(EventSourcesService(self.rt))
        # hermetic tenant state: the seeding runtime's registrations land
        # on each tenant's registry-state topic; workers adopt by replay
        reg_rt = ServiceRuntime(InstanceSettings(
            instance_id=INSTANCE, registry_replication=True), bus=self.bus)
        reg_rt.add_service(DeviceManagementService(reg_rt))
        await reg_rt.start()
        for tid in cfg.tenant_ids:
            await reg_rt.add_tenant(TenantConfig(tenant_id=tid))
            reg_rt.api("device-management").management(tid).bootstrap_fleet(
                DeviceType(token="thermo", name="T"), cfg.per_tenant)
        await reg_rt.stop()  # the replicator's seal: snapshots on the bus
        mark("registry")
        self.broker = BusServer(self.bus)
        # the autoscaler pinned to the measured topology: the floor check
        # (the kill drill's replacement) stays live, load-driven scaling
        # and migration cannot perturb the measured phases
        self.controller = FleetController(
            self.rt, policy=AutoscalerPolicy(
                min_workers=cfg.workers, max_workers=cfg.workers,
                scale_up_lag=1e18, imbalance_ratio=1e18),
            spawner=self._spawn)
        self.rt.add_child(self.controller)
        await self.rt.start()
        await self.broker.start()
        for _ in range(cfg.workers):
            self.controller.request_replica()
        # the tenants are placed while the workers start, as the bench
        # does: the first worker to join adopts them all and the next
        # one's placement moves tenants that are still starting
        sections = tenant_sections(SplitConfig(
            devices=cfg.per_tenant, model=cfg.model, window=WINDOW))
        for tid in cfg.tenant_ids:
            # spins the local event-sources engine and registers the
            # tenant for placement
            await self.rt.add_tenant(TenantConfig(tenant_id=tid,
                                                  sections=sections))
        self.receivers = {tid: self.rt.api("event-sources").engine(tid)
                          .receiver("default") for tid in cfg.tenant_ids}
        self.meters = {tid: self.bus.subscribe(
            self.rt.naming.tenant_topic(tid, TopicNaming.SCORED_EVENTS),
            group="fleet-meter") for tid in cfg.tenant_ids}
        await self.converged(READY_TIMEOUT_S, workers=cfg.workers)
        mark("converged")

    async def converged(self, timeout: float, *, workers: int,
                        without: Optional[str] = None) -> float:
        """Wait until every tenant is adopted by a live worker, `workers`
        of them heartbeating (and `without` gone); returns the wait."""
        t0 = time.monotonic()
        while True:
            self.check_workers()
            snap = self.controller.snapshot()
            if snap["converged"] and len(snap["workers"]) >= workers \
                    and without not in snap["workers"] \
                    and all(w in self.api_ports for w in snap["workers"]):
                return time.monotonic() - t0
            if time.monotonic() - t0 > timeout:
                raise TimeoutError(f"fleet did not converge in {timeout} s"
                                   f"{self.diagnose()}")
            self.drain()
            await asyncio.sleep(0.05)

    # -- traffic ----------------------------------------------------------

    def drain(self) -> None:
        for tid, consumer in self.meters.items():
            for record in consumer.poll_nowait(max_records=256):
                self.scored[tid] += len(record.value)
                if self.keep is not None:
                    self.keep[tid].append(record.value)

    def outstanding(self, tid: str) -> int:
        return self.sent[tid] - self.scored[tid]

    async def submit(self, tid: str, payload: bytes, n: int) -> None:
        if not await self.receivers[tid].submit(payload):
            raise AssertionError(f"fleet: a tick of {tid} was shed at "
                                 f"ingress")
        self.sent[tid] += n

    async def send(self, ticks: dict) -> None:
        """Every tenant's ticks, tick by tick across tenants, with at most
        32 ticks a tenant unscored (the shared bus is the queue)."""
        cap = 32 * self.cfg.per_tenant
        for k in range(max(map(len, ticks.values()))):
            for tid, batches in ticks.items():
                if k >= len(batches):
                    continue
                deadline = time.monotonic() + DRAIN_TIMEOUT_S
                while self.outstanding(tid) >= cap:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"fleet: {tid} held 32 ticks "
                                           f"unscored for "
                                           f"{DRAIN_TIMEOUT_S} s"
                                           f"{self.diagnose()}")
                    self.check_workers()
                    self.drain()
                    await asyncio.sleep(0.002)
                await self.submit(tid, batches[k].encode(),
                                  len(batches[k]))
            self.drain()

    async def caught_up(self, timeout: float) -> float:
        """Wait until every tenant's scored count reaches its sent count;
        returns the monotonic time the last record arrived."""
        deadline = time.monotonic() + timeout
        t_last = time.monotonic()
        while any(self.scored[t] < self.sent[t] for t in self.sent):
            if time.monotonic() > deadline:
                raise TimeoutError(f"fleet: not every event scored in "
                                   f"{timeout} s{self.diagnose()}")
            self.check_workers()
            before = sum(self.scored.values())
            self.drain()
            if sum(self.scored.values()) != before:
                t_last = time.monotonic()
            await asyncio.sleep(0.001)
        return t_last

    async def drained(self, timeout: float) -> dict:
        """Wait until every tenant consumer group has committed through
        its topics' end offsets; returns the lags (all 0)."""
        deadline = time.monotonic() + timeout
        prefixes = tuple(f"{tid}." for tid in self.cfg.tenant_ids)
        while True:
            lags = {g: dict(v) for g, v in self.bus.group_lags().items()
                    if g.startswith(prefixes)}
            if lags and not any(n for v in lags.values() for n in v.values()):
                return lags
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet: committed offsets short of the "
                                     f"end after {timeout} s"
                                     f"{self.diagnose()}")
            self.check_workers()
            self.drain()
            await asyncio.sleep(0.05)

    def decoded_backlog(self) -> int:
        lags = self.bus.group_lags()
        return sum(sum(lags.get(f"{tid}.inbound-processing", {}).values())
                   for tid in self.cfg.tenant_ids)

    def busiest(self) -> tuple[Optional[str], tuple]:
        snap = self.controller.snapshot()
        live = set(self.live())
        ranked = sorted(((len(w["owned"]), wid)
                         for wid, w in snap["workers"].items()
                         if wid in live), reverse=True)
        if not ranked:
            return None, ()
        victim = ranked[0][1]
        return victim, tuple(snap["workers"][victim]["owned"])

    async def flood(self, sims: dict, t0_tick: float, seconds: float, *,
                    kill_at: float = -1.0, stop_at: float = -1.0):
        """Offered load on every tenant for `seconds` (32 ticks a tenant
        outstanding at most); `kill_at` SIGKILLs the busiest worker,
        `stop_at` SIGSTOPs it and SIGCONTs it once the controller has
        declared it dead (mid-reassignment). Returns (events accepted by
        tenant, the drill's record, the next tick's time)."""
        cfg = self.cfg
        cap = 32 * cfg.per_tenant
        sent = {tid: 0 for tid in cfg.tenant_ids}
        info = None
        t0 = time.monotonic()
        k = 0
        while (time.monotonic() - t0 < seconds
               or (stop_at >= 0 and info is not None
                   and info.get("t_cont") is None)):
            if time.monotonic() - t0 > seconds + READY_TIMEOUT_S:
                raise TimeoutError(f"fleet: {info['worker']} not declared "
                                   f"dead{self.diagnose()}")
            progressed = False
            for tid in cfg.tenant_ids:
                if self.outstanding(tid) >= cap:
                    continue
                batch, _ = sims[tid].tick(t=t0_tick + TICK_S * k)
                await self.submit(tid, batch.encode(), len(batch))
                sent[tid] += len(batch)
                progressed = True
            k += 1
            self.check_workers()
            self.drain()
            if not progressed:
                await asyncio.sleep(0.002)
            elapsed = time.monotonic() - t0
            if kill_at >= 0 and info is None and elapsed >= kill_at:
                victim, owned = self.busiest()
                if victim is not None:
                    self.expected_dead.add(victim)
                    self.procs[victim].kill()
                    info = {"worker": victim, "owned": list(owned),
                            "t_kill": time.monotonic()}
            if stop_at >= 0 and info is None and elapsed >= stop_at:
                victim, owned = self.busiest()
                if victim is not None:
                    self.procs[victim].send_signal(signal.SIGSTOP)
                    info = {"worker": victim, "owned": list(owned),
                            "t_stop": time.monotonic()}
            if stop_at >= 0 and info is not None \
                    and info.get("t_cont") is None \
                    and info["worker"] not in \
                    self.controller.snapshot()["workers"]:
                self.procs[info["worker"]].send_signal(signal.SIGCONT)
                info["t_cont"] = time.monotonic()
                info["declared_dead_s"] = info["t_cont"] - info["t_stop"]
        return sent, info, t0_tick + TICK_S * k

    # -- teardown ---------------------------------------------------------

    async def stop(self) -> dict:
        """SIGTERM every live worker, then the broker and the runtime;
        returns each worker's exit code."""
        rcs = {}
        self.closing = True
        try:
            for proc in self.procs.values():
                if proc.poll() is None:
                    proc.terminate()
            deadline = time.monotonic() + 60.0
            for wid, proc in list(self.procs.items()):
                try:
                    rcs[wid] = await asyncio.get_running_loop().run_in_executor(
                        None, proc.wait, max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    proc.kill()
                    rcs[wid] = proc.wait()
        finally:
            for consumer in self.meters.values():
                consumer.close()
            if self.broker is not None:
                await self.broker.stop()
            if self.rt is not None:
                await self.rt.stop()
            for f in self.stderr.values():
                f.close()
            if self._dir is not None:
                shutil.rmtree(self._dir, ignore_errors=True)
        return rcs


def prebuild(cfg: FleetConfig) -> None:
    """Build the kernels and the store's host library once, here, before
    any worker starts: the workers then load them."""
    from sitewhere_tpu_torch.ops import build

    if cfg.device == "cpu":
        build.library("swx_native")
    else:
        build.build_all()


def stats_delta(before: dict, after: dict) -> dict:
    """Per worker over a phase: dispatches, K1 launches, tenants owned."""
    return {wid: {"dispatches": s["dispatches"]
                  - before.get(wid, {}).get("dispatches", 0),
                  "kernel_launches": s["kernel_launches"]
                  - before.get(wid, {}).get("kernel_launches", 0),
                  "owned": s["owned"]}
            for wid, s in after.items()}


async def kill_drill(fleet: Fleet, sims: dict, t_next: float):
    """SIGKILL the busiest worker mid-flood; everything accepted must be
    scored, the decoded topics drained and the fleet whole again."""
    cfg, rt = fleet.cfg, fleet.rt
    deaths = rt.metrics.counter("fleet.worker_deaths")
    deaths0, base = deaths.value, dict(fleet.scored)
    sent, info, t_next = await fleet.flood(sims, t_next, FLOOD_S,
                                           kill_at=KILL_AT * FLOOD_S)
    if info is None:
        raise AssertionError("fleet: no worker to kill")
    logger.info("fleet: SIGKILL %s (owned %s)", info["worker"], info["owned"])
    t_kill = info["t_kill"]
    # seconds from the SIGKILL: the death declared, the victim's tenants
    # owned by live workers again, the placement converged without it
    detect_s = reassigned_s = converged_s = None
    deadline = time.monotonic() + READY_TIMEOUT_S
    while converged_s is None:
        if time.monotonic() > deadline:
            raise TimeoutError(f"fleet: no reconvergence after killing "
                               f"{info['worker']}{fleet.diagnose()}")
        snap = fleet.controller.snapshot()
        now = time.monotonic() - t_kill
        gone = info["worker"] not in snap["workers"]
        if gone and detect_s is None:
            detect_s = now
        if gone and reassigned_s is None and all(
                snap["owners"].get(t) in snap["workers"]
                for t in info["owned"]):
            reassigned_s = now
        if gone and snap["converged"]:
            converged_s = now
        fleet.check_workers()
        fleet.drain()
        await asyncio.sleep(0.02)
    await fleet.caught_up(DRAIN_TIMEOUT_S)
    await fleet.converged(READY_TIMEOUT_S, workers=cfg.workers,
                          without=info["worker"])
    replaced_s = time.monotonic() - t_kill
    lags = await fleet.drained(DRAIN_TIMEOUT_S)
    lost = sum(max(fleet.sent[t] - fleet.scored[t], 0) for t in fleet.sent)
    return {
        "killed_worker": info["worker"],
        "killed_owned": info["owned"],
        "death_detected": deaths.value > deaths0,
        "detected_after_kill_s": detect_s,
        "dead_after_s": DEAD_AFTER_S,
        "reassigned_after_kill_s": reassigned_s,
        "converged_after_kill_s": converged_s,
        "replacement_joined_s": replaced_s,
        "replacement_spawned": len(fleet.live()) >= cfg.workers,
        "accepted_events": int(sum(sent.values())),
        "scored_events": int(sum(fleet.scored[t] - base[t]
                                 for t in fleet.sent)),
        "lost_accepted_events": int(lost),
        "replayed_events": int(sum(max(fleet.scored[t] - fleet.sent[t], 0)
                                   for t in fleet.sent)),
        "decoded_backlog_after_drain": fleet.decoded_backlog(),
        "groups_drained": len(lags),
    }, t_next


async def zombie_drill(fleet: Fleet, sims: dict, t_next: float):
    """SIGSTOP the busiest worker past the death bound, SIGCONT it
    mid-reassignment under live traffic: its writes are fenced, nothing
    accepted is lost, and a flood after reconvergence lands exactly
    once (`bench.py:1054-1126`)."""
    cfg, rt, bus = fleet.cfg, fleet.rt, fleet.bus
    deaths = rt.metrics.counter("fleet.worker_deaths")
    deaths0, base = deaths.value, dict(fleet.scored)
    rejections0 = bus.fences.rejections if bus.fences is not None else 0
    sent, info, t_next = await fleet.flood(sims, t_next, FLOOD_S,
                                           stop_at=0.3 * FLOOD_S)
    if info is None:
        raise AssertionError("fleet: no worker to stop")
    await fleet.converged(READY_TIMEOUT_S, workers=1)
    reconverged_s = time.monotonic() - info["t_stop"]
    await fleet.caught_up(DRAIN_TIMEOUT_S)
    await fleet.drained(DRAIN_TIMEOUT_S)
    backlog = fleet.decoded_backlog()
    lost = sum(max(fleet.sent[t] - fleet.scored[t], 0) for t in fleet.sent)
    fenced = (bus.fences.rejections if bus.fences is not None else 0) \
        - rejections0
    post_base = dict(fleet.scored)
    post_sent, _, t_next = await fleet.flood(sims, t_next,
                                             min(FLOOD_S, 5.0))
    await fleet.caught_up(DRAIN_TIMEOUT_S)
    post_dup = sum(fleet.scored[t] - post_base[t] for t in fleet.sent) \
        - sum(post_sent.values())
    return {
        "zombie_worker": info["worker"],
        "zombie_owned": info["owned"],
        "false_positive_death_detected": deaths.value > deaths0,
        "declared_dead_s": info.get("declared_dead_s"),
        "sigcont_mid_reassignment": info.get("t_cont") is not None,
        "reconverged_after_stop_s": reconverged_s,
        "fenced_rejections": int(max(fenced, 0)),
        "accepted_events": int(sum(sent.values())),
        "scored_events": int(sum(fleet.scored[t] - base[t]
                                 for t in fleet.sent)),
        "lost_accepted_events": int(lost),
        "decoded_backlog_after_drain": backlog,
        "post_reconverge_accepted": int(sum(post_sent.values())),
        "duplicate_committed_events": int(max(post_dup, 0)),
    }, t_next


async def run(cfg: FleetConfig) -> tuple[dict, dict]:
    """The fleet sequence (module docstring). Returns (the report,
    {"ticks": {tenant: [(batch, truth)] warm then burst}, "burst":
    {tenant: scored batches of the burst}})."""
    plan = warm_and_burst(cfg)
    ticks, sims = plan["ticks"], plan["sims"]
    warm_n = WINDOW + 4
    fleet = Fleet(cfg)
    t_setup = time.perf_counter()
    try:
        await fleet.start()
        setup_s = time.perf_counter() - t_setup
        logger.info("fleet: converged, set-up %s", fleet.setup_s)
        converge_s = fleet.setup_s["converged"] - fleet.setup_s["registry"]
        await fleet.send({t: [b for b, _ in v[:warm_n]]
                          for t, v in ticks.items()})
        await fleet.caught_up(DRAIN_TIMEOUT_S)
        logger.info("fleet: %d warm ticks a tenant scored", warm_n)
        before = await fleet.worker_stats()
        fleet.keep = {tid: [] for tid in cfg.tenant_ids}
        t0 = time.monotonic()
        await fleet.send({t: [b for b, _ in v[warm_n:]]
                          for t, v in ticks.items()})
        t_last = await fleet.caught_up(DRAIN_TIMEOUT_S)
        burst_events = BURST_TICKS * cfg.per_tenant * TENANTS
        rate = burst_events / max(t_last - t0, 1e-9)
        burst = fleet.keep
        fleet.keep = None
        for tid in cfg.tenant_ids:
            check_once(f"fleet {tid}", [b for b, _ in ticks[tid][warm_n:]],
                       burst[tid])
        workers = stats_delta(before, await fleet.worker_stats())
        logger.info("fleet: burst at %.0f events/s, workers %s", rate,
                    workers)
        lags = await fleet.drained(DRAIN_TIMEOUT_S)
        t_next = TICK_S * (warm_n + BURST_TICKS)
        kill = zombie = None
        if cfg.workers >= 2:
            kill, t_next = await kill_drill(fleet, sims, t_next)
            logger.info("fleet: kill drill %s", kill)
            if cfg.zombie:
                zombie, t_next = await zombie_drill(fleet, sims, t_next)
        snap = fleet.controller.snapshot()
        report = {
            "deployment": f"fleet (bus+ingress+controller | {cfg.workers} "
                          f"worker processes)",
            "model": cfg.model, "workers": cfg.workers,
            "tenants": TENANTS, "devices": cfg.per_tenant * TENANTS,
            "setup_s": setup_s, "setup_steps_s": fleet.setup_s,
            "converge_s": converge_s,
            "burst_events": burst_events, "events_per_s": rate,
            "burst_workers": workers,
            "groups_drained": sorted(lags),
            "kill": kill, "zombie": zombie,
            "epoch": snap["epoch"],
            "rebalances": int(fleet.controller.rebalances),
            "fence_rejections_total": (fleet.bus.fences.rejections
                                       if fleet.bus.fences is not None
                                       else 0),
            "autoscaler_decisions": fleet.controller.decisions[-8:],
            "retired": fleet.retired(),
        }
    finally:
        rcs = await fleet.stop()
    report["worker_exits"] = rcs
    bad = {w: rc for w, rc in rcs.items()
           if rc != 0 and w not in fleet.expected_dead}
    if bad:
        raise WorkerDied(f"fleet workers exited {bad} after SIGTERM")
    return report, {"ticks": ticks, "burst": burst}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sitewhere_tpu_torch.tools.fleet")
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--devices", type=int, default=32768)
    parser.add_argument("--model", default="lstm",
                        choices=["lstm", "lstm-stream"])
    parser.add_argument("--zombie-drill", action="store_true")
    parser.add_argument("--cpu", action="store_true",
                        help="score on the CPU instead of the CUDA card")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.WARNING)
    logger.setLevel(logging.INFO)
    cfg = FleetConfig(workers=args.workers, devices=args.devices,
                      model=args.model, zombie=args.zombie_drill,
                      device="cpu" if args.cpu else None)
    report, _ = asyncio.run(run(cfg))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
