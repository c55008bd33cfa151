"""The port's telemetry store on its host library (`csrc/swx_native.cpp`
through `persistence/native.py`) held against the store's numpy plain
versions (`append_plain`, `window_plain`, `window_ts_plain`,
`latest_plain`) and against the JAX package's `TelemetryTable` /
`TelemetryStore` on the same numpy inputs. Everything here is host code
on the same float32/float64 values: the comparisons are exact (bit for
bit), in-batch duplicates and ring wraparound included."""

import numpy as np
import pytest

from sitewhere_tpu.domain.batch import BatchContext as JBatchContext
from sitewhere_tpu.domain.batch import MeasurementBatch as JBatch
from sitewhere_tpu.persistence.telemetry import TelemetryStore as JStore
from sitewhere_tpu.persistence.telemetry import TelemetryTable as JTable
from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.ops import build
from sitewhere_tpu_torch.persistence import native
from sitewhere_tpu_torch.persistence import telemetry as tel

DEVICES, HISTORY, W = 256, 32, 16


def _ticks(case: str, seed: int = 0, n_ticks: int = 6):
    """(dev, values, ts) ticks: `uniform` draws over the fleet (in-batch
    duplicates), `hot` puts half of each tick on four devices (their
    rings wrap within a tick), `sparse` touches a few devices once."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n_ticks):
        if case == "uniform":
            dev = rng.integers(0, DEVICES, 300)
        elif case == "hot":
            dev = rng.permutation(np.concatenate([
                rng.integers(0, DEVICES, 128), rng.integers(0, 4, 128)]))
        else:
            dev = rng.choice(DEVICES, 5, replace=False)
        dev = dev.astype(np.uint32)
        val = rng.normal(20.0, 5.0, dev.shape[0]).astype(np.float32)
        ts = 60.0 * k + np.sort(rng.random(dev.shape[0]))
        out.append((dev, val, ts))
    return out


def _state(table) -> tuple:
    return tuple(getattr(table, f).tobytes()
                 for f in ("values", "ts", "cursor", "count"))


def _reads(table, reads) -> list[bytes]:
    devices = np.arange(DEVICES, dtype=np.uint32)
    window, window_ts, latest = reads
    x, valid = window(table, devices, W)
    v, t = latest(table, devices)
    return [a.tobytes() for a in (x, valid, window_ts(table, devices, W), v, t)]


NATIVE_READS = (lambda t, d, w: t.window(d, w),
                lambda t, d, w: t.window_ts(d, w),
                lambda t, d: t.latest(d))
PLAIN_READS = (tel.window_plain, tel.window_ts_plain, tel.latest_plain)


@pytest.mark.parametrize("case", ["uniform", "hot", "sparse"])
def test_native_matches_plain_and_jax_table(case):
    """Tick for tick, the library's ring (values, ts, cursor, count) is
    bit-equal to the plain append's and to the JAX package's table; the
    reads agree bit for bit at the end."""
    port = tel.TelemetryTable(HISTORY, DEVICES)
    plain = tel.TelemetryTable(HISTORY, DEVICES)
    jax_table = JTable(HISTORY, DEVICES)
    seen = np.zeros(DEVICES, np.int64)
    for dev, val, ts in _ticks(case):
        port.append(dev, val, ts)
        tel.append_plain(plain, dev, val, ts)
        jax_table.append(dev, val, ts)
        seen += np.bincount(dev, minlength=DEVICES)
        assert _state(port) == _state(plain) == _state(jax_table)
    if case == "hot":
        assert (seen > HISTORY).sum() >= 4  # the hot rings wrapped
    assert port.total_appended == plain.total_appended == seen.sum()
    assert _reads(port, NATIVE_READS) == _reads(plain, PLAIN_READS)
    assert _reads(port, NATIVE_READS) == _reads(jax_table, NATIVE_READS)


def test_in_batch_duplicates_keep_arrival_order():
    for append in (lambda t, *a: t.append(*a), tel.append_plain):
        t = tel.TelemetryTable(history=8, initial_devices=4)
        append(t, np.array([1, 1, 1, 2, 1], np.uint32),
               np.arange(5, dtype=np.float32), np.ones(5))
        x, valid = t.window(np.array([1, 2], np.uint32), 4)
        assert x[0].tolist() == [0.0, 1.0, 2.0, 4.0]
        assert valid[0].all()
        assert x[1][-1] == 3.0 and valid[1].tolist() == [False] * 3 + [True]


def test_ring_wraparound_keeps_the_newest():
    t = tel.TelemetryTable(history=4, initial_devices=2)
    for k in range(10):
        t.append(np.array([0], np.uint32), np.array([float(k)], np.float32),
                 np.array([float(k)]))
    x, valid = t.window(np.array([0], np.uint32), 4)
    assert x[0].tolist() == [6.0, 7.0, 8.0, 9.0] and valid[0].all()
    assert t.window_ts(np.array([0]), 2)[0].tolist() == [8.0, 9.0]
    v, ts = t.latest(np.array([0, 1]))
    assert v.tolist() == [9.0, 0.0] and ts.tolist() == [9.0, 0.0]


def test_growth_and_empty_reads_match_plain():
    """Indices past the capacity grow the table on both paths; an empty
    read returns empty arrays of the read's dtypes."""
    port, plain = tel.TelemetryTable(8, 4), tel.TelemetryTable(8, 4)
    dev = np.array([3, 900, 17, 900], np.uint32)
    val = np.arange(4, dtype=np.float32)
    port.append(dev, val, np.arange(4.0))
    tel.append_plain(plain, dev, val, np.arange(4.0))
    assert port.capacity == plain.capacity >= 901
    assert _state(port) == _state(plain)
    none = np.array([], np.int64)
    for got, want in zip((*port.window(none, 5), port.window_ts(none, 5),
                          *port.latest(none)),
                         (*tel.window_plain(plain, none, 5),
                          tel.window_ts_plain(plain, none, 5),
                          *tel.latest_plain(plain, none))):
        assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("call", ["append", "window", "latest", "plain"])
def test_negative_index_raises(call):
    t = tel.TelemetryTable(8, 4)
    bad = np.array([1, -1], np.int64)
    with pytest.raises(ValueError, match="negative device index"):
        if call == "append":
            t.append(bad, np.zeros(2, np.float32), np.zeros(2))
        elif call == "window":
            t.window(bad, 4)
        elif call == "latest":
            t.latest(bad)
        else:
            tel.append_plain(t, bad, np.zeros(2, np.float32), np.zeros(2))


def test_store_matches_jax_store_across_channels():
    """`TelemetryStore.append_measurements` over two channels and the
    snapshot view, against the JAX package's store."""
    rng = np.random.default_rng(3)
    port, jstore = tel.TelemetryStore(HISTORY, 64), JStore(HISTORY, 64)
    for k in range(5):
        n = 200
        dev = rng.integers(0, DEVICES, n).astype(np.uint32)
        mtype = rng.integers(0, 2, n).astype(np.uint16)
        val = rng.normal(size=n).astype(np.float32)
        ts = np.full(n, 60.0 * k)
        port.append_measurements(MeasurementBatch(
            BatchContext("t"), dev, mtype, val, ts))
        jstore.append_measurements(JBatch(JBatchContext("t"), dev, mtype,
                                          val, ts))
    assert port.total_events == jstore.total_events == 1000
    devices = np.arange(DEVICES)
    for mt in (0, 1):
        for got, want in zip(port.window(devices, W, mt),
                             jstore.window(devices, W, mt)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(port.snapshot(mt), jstore.snapshot(mt)):
            np.testing.assert_array_equal(got, want)


def test_library_is_built_from_the_port_source_into_build():
    target = build._target("swx_native")
    assert target.name == "libswx_native.so"
    assert target.parent.parent == build.BUILD_ROOT
    assert build.HOST_SOURCES["swx_native"] == "swx_native.cpp"
    assert (build.CSRC / "swx_native.cpp").exists()
    assert native.get_lib() is native.get_lib()
    assert target.exists()


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source g++ refuses raises at build time; nothing is loaded and
    no temporary file is left behind."""
    fake = tmp_path / "csrc"
    fake.mkdir()
    (fake / "swx_native.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", fake)
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path / "out")
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for swx_native.cpp"):
        build.library("swx_native")
    assert not list((tmp_path / "out").rglob("*.so*"))


def test_store_has_no_fallback_when_the_library_fails(monkeypatch):
    """With the library unavailable the store raises on every path; it
    never falls back to the plain versions."""
    def broken():
        raise RuntimeError("g++ not found")

    monkeypatch.setattr(tel, "get_lib", broken)
    t = tel.TelemetryTable(8, 4)
    dev = np.array([0, 1], np.uint32)
    for call in (lambda: t.append(dev, np.zeros(2, np.float32), np.zeros(2)),
                 lambda: t.window(dev, 4), lambda: t.window_ts(dev, 4),
                 lambda: t.latest(dev)):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            call()
