"""The port's durable storage (`persistence/durable.py`: `SegmentLog`,
`DurableEventLog`, `TelemetryHistory`, `WriteAheadLog`, snapshots; and
the event store's spill and replay in `persistence/memory.py`) held
against the JAX package's. The on-disk formats are the same byte for
byte: whatever one package writes, the other reads back identically,
and both treat a torn tail and a CRC failure the same way. The spill
writer's guarantee is the reference's: a bounded queue that drops the
newest record and counts it when the disk falls behind. Host code on
the same values: every comparison is exact."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest

from sitewhere_tpu.domain import batch as jbatch
from sitewhere_tpu.domain import events as jevents
from sitewhere_tpu.domain import model as jmodel
from sitewhere_tpu.persistence import durable as jdurable
from sitewhere_tpu.persistence import memory as jmemory
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.domain import events as tevents
from sitewhere_tpu_torch.domain import model as tmodel
from sitewhere_tpu_torch.persistence import durable as tdurable
from sitewhere_tpu_torch.persistence import memory as tmemory

JAX = SimpleNamespace(batch=jbatch, events=jevents, model=jmodel,
                      durable=jdurable, memory=jmemory)
PORT = SimpleNamespace(batch=tbatch, events=tevents, model=tmodel,
                       durable=tdurable, memory=tmemory)
WAYS = {"jax-to-port": (JAX, PORT), "port-to-jax": (PORT, JAX)}


def _batch(pkg, n=16, base=0.0):
    return pkg.batch.MeasurementBatch(
        pkg.batch.BatchContext(tenant_id="acme", source="test"),
        np.arange(n, dtype=np.uint32), np.zeros(n, np.uint16),
        (np.arange(n) + base).astype(np.float32),
        np.full(n, 1000.0 + base, np.float64))


def _records(pkg, root) -> list:
    return [(t, bytes(p)) for t, p in pkg.durable.SegmentLog(str(root)).replay()]


def test_record_constants_and_framing_match():
    for name in ("RT_MEASUREMENTS", "RT_LOCATIONS", "RT_COLD",
                 "RT_TELEMETRY", "_SEG_FMT"):
        assert getattr(tdurable, name) == getattr(jdurable, name)
    for name in ("_REC", "_WAL_REC", "_SNAP"):
        assert getattr(tdurable, name).format == getattr(jdurable, name).format
    assert (tmemory.RT_MEASUREMENTS, tmemory.RT_LOCATIONS, tmemory.RT_COLD) \
        == (1, 2, 3)


@pytest.mark.parametrize("way", list(WAYS))
def test_segment_logs_read_in_the_other_package(tmp_path, way):
    """Rotated segments written by one package: the other lists the same
    segments and replays the same records in order."""
    src, dst = WAYS[way]
    log = src.durable.SegmentLog(str(tmp_path), segment_bytes=256)
    payloads = [f"rec-{i:04d}".encode() * (1 + i % 5) for i in range(60)]
    for i, p in enumerate(payloads):
        log.append(i % 4 + 1, p)
    log.close()
    assert len(log._segments()) > 1
    assert _records(dst, tmp_path) == _records(src, tmp_path) \
        == [(i % 4 + 1, p) for i, p in enumerate(payloads)]
    assert dst.durable.SegmentLog(str(tmp_path))._seq \
        == src.durable.SegmentLog(str(tmp_path))._seq


@pytest.mark.parametrize("fault", ["torn", "crc"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_tail_and_crc_failure_end_replay_alike(tmp_path, writer, fault):
    pkg = JAX if writer == "jax" else PORT
    log = pkg.durable.SegmentLog(str(tmp_path))
    for p in (b"good-record", b"second-good", b"third-gone"):
        log.append(1, p)
    log.close()
    seg = log._segments()[-1][1]
    data = bytearray(open(seg, "rb").read())
    if fault == "torn":
        data = data[:-4]
    else:
        data[-1] ^= 0xFF
    open(seg, "wb").write(bytes(data))
    want = [(1, b"good-record"), (1, b"second-good")]
    assert _records(JAX, tmp_path) == _records(PORT, tmp_path) == want


@pytest.mark.parametrize("way", list(WAYS))
def test_spill_log_and_store_replay_across_packages(tmp_path, way):
    """The event store's spill (measurements, locations, a cold alert)
    written through one package's DurableEventLog restarts the other's
    store with the same windows and alerts, and replay writes nothing."""
    src, dst = WAYS[way]
    em = src.memory.InMemoryDeviceEventManagement(
        src.memory.InMemoryDeviceManagement(), history=64,
        durable=src.durable.DurableEventLog(str(tmp_path)))
    for k in range(5):
        em.add_measurements(_batch(src, 16, base=k * 100.0))
    n = 4
    em.add_locations(src.batch.LocationBatch(
        src.batch.BatchContext(tenant_id="acme"),
        np.arange(n, dtype=np.uint32), np.linspace(1, 2, n),
        np.linspace(3, 4, n), np.ones(n, np.float32), np.full(n, 7.0)))
    em.add_alerts([src.events.DeviceAlert(device_id="d0", message="boom")])
    em.durable.close()
    assert em.durable.written == 7 and em.durable.dropped == 0

    em2 = dst.memory.InMemoryDeviceEventManagement(
        dst.memory.InMemoryDeviceManagement(), history=64,
        durable=dst.durable.DurableEventLog(str(tmp_path)))
    em2.durable.close()
    assert em2.telemetry.total_events == em.telemetry.total_events == 80
    devices = np.arange(16)
    for got, want in zip(em2.telemetry.window(devices, 8),
                         em.telemetry.window(devices, 8)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(em2.telemetry.locations.latest(np.arange(n)),
                         em.telemetry.locations.latest(np.arange(n))):
        np.testing.assert_array_equal(got, want)
    assert [(a.device_id, a.message) for a in em2.alerts] == [("d0", "boom")]
    assert len(_records(dst, tmp_path)) == 7


class _Gate:
    """A `durable.flush` fault site that holds the writer thread until
    released: the disk "falls behind"."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def check(self, site):
        assert site == "durable.flush"
        self.entered.set()
        self.release.wait(10.0)


def _drop_trace(pkg, root) -> tuple:
    gate = _Gate()
    dlog = pkg.durable.DurableEventLog(str(root), queue_max=3, faults=gate)
    dlog.submit(pkg.durable.RT_MEASUREMENTS, _batch(pkg, 4, base=0.0))
    assert gate.entered.wait(10.0)  # the writer holds record 0
    for k in range(1, 10):
        dlog.submit(pkg.durable.RT_MEASUREMENTS, _batch(pkg, 4, base=k))
    dropped_while_blocked = dlog.dropped
    gate.release.set()
    dlog.close()
    bases = [float(pkg.batch.MeasurementBatch.decode(
        p, pkg.batch.BatchContext(tenant_id="acme")).ts[0] - 1000.0)
        for _, p in _records(pkg, root)]
    return dropped_while_blocked, dlog.dropped, dlog.written, bases


def test_spill_queue_drops_the_newest_and_counts_like_the_reference(tmp_path):
    """Queue of 3 behind a stalled writer: both packages accept the same
    records, drop the same newest ones, count them, and never block the
    submitter."""
    got = _drop_trace(PORT, tmp_path / "port")
    want = _drop_trace(JAX, tmp_path / "jax")
    assert got == want
    assert got[1] == 6 and got[2] == 4 and got[3] == [0.0, 1.0, 2.0, 3.0]


def test_write_errors_are_counted_and_the_writer_survives(tmp_path):
    class FailTwice:
        n = 0

        def check(self, site):
            self.n += 1
            if self.n <= 2:
                raise OSError("disk fault")

    for pkg, sub in ((PORT, "port"), (JAX, "jax")):
        dlog = pkg.durable.DurableEventLog(str(tmp_path / sub),
                                           faults=FailTwice())
        for k in range(5):
            dlog.submit(pkg.durable.RT_MEASUREMENTS, _batch(pkg, 2, base=k))
        dlog.close()
        assert (dlog.write_errors, dlog.written) == (2, 3)
        assert len(_records(pkg, tmp_path / sub)) == 3


@pytest.mark.parametrize("way", list(WAYS))
def test_wal_replays_in_the_other_package(tmp_path, way):
    src, dst = WAYS[way]
    path = str(tmp_path / "registry.wal")
    wal = src.durable.WriteAheadLog(path)
    payloads = [f"mutation-{i}".encode() * (i + 1) for i in range(12)]
    for p in payloads:
        wal.append(p)
    wal.close()
    assert dst.durable.WriteAheadLog(path).replay() == payloads
    # a torn tail (the append a crash interrupted) ends replay alike
    with open(path, "ab") as f:
        f.write(b"\x40\x00\x00\x00\xde\xad\xbe\xefhalf")
    assert dst.durable.WriteAheadLog(path).replay() \
        == src.durable.WriteAheadLog(path).replay() == payloads
    reset = dst.durable.WriteAheadLog(path)
    reset.reset()
    reset.close()
    assert src.durable.WriteAheadLog(path).replay() == []


@pytest.mark.parametrize("way", list(WAYS))
def test_registry_snapshots_load_in_the_other_package(tmp_path, way):
    src, dst = WAYS[way]
    dm = src.memory.InMemoryDeviceManagement()
    dt = dm.create_device_type(src.model.DeviceType(token="thermo"))
    for i in range(5):
        d = dm.create_device(src.model.Device(token=f"d{i}",
                                              device_type_id=dt.id))
        dm.create_device_assignment(src.model.DeviceAssignment(
            device_id=d.id, token=f"d{i}-a"))
    path = str(tmp_path / "registry.snap")
    src.durable.save_snapshot(path, dm.to_snapshot())
    snap = dst.durable.load_snapshot(path)
    dm2 = dst.memory.InMemoryDeviceManagement()
    dm2.restore_snapshot(snap)
    assert dm2.device_count() == 5
    assert [d.token for d in sorted(dm2.devices.by_id.values(),
                                    key=lambda d: d.index)] \
        == [f"d{i}" for i in range(5)]
    assert dm2.to_snapshot() == snap
    # a corrupt or truncated snapshot is absent in both packages
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert src.durable.load_snapshot(path) is None
    assert dst.durable.load_snapshot(path) is None
    open(path, "wb").write(b"\x01")
    assert dst.durable.load_snapshot(path) is None
    assert dst.durable.load_snapshot(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("way", list(WAYS))
def test_telemetry_history_reads_in_the_other_package(tmp_path, way):
    """Window rows a runtime's telemetry history closed in one package
    are replayed by the other with the same series and rows."""
    src, dst = WAYS[way]
    hist = src.durable.TelemetryHistory(str(tmp_path), window_s=1.0)
    rng = np.random.default_rng(5)
    for k in range(200):
        t = 100.0 + k * 0.05
        hist.append("acme", "lag", float(rng.integers(0, 50)), t=t)
        hist.append("beta", "egress_backlog", float(rng.normal()), t=t)
    hist.close()
    want = src.durable.TelemetryHistory(str(tmp_path), window_s=1.0)
    got = dst.durable.TelemetryHistory(str(tmp_path), window_s=1.0)
    assert got.replayed == want.replayed == 20
    assert got.series() == want.series()
    for tenant, signal in want.series():
        assert got.history(tenant, signal) == want.history(tenant, signal)
        assert got.history(tenant, signal, since=102.0, until=105.0,
                           limit=2) == want.history(
            tenant, signal, since=102.0, until=105.0, limit=2)
    assert got.stats() == want.stats()
    got.close()
    want.close()
