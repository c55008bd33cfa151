"""The port's historical replay plane (`history/`: `EventHistoryStore`,
`ReplayEngine`, `ScoreCollector`) held against the JAX package's on the
CPU, plus tests/test_history.py's own cases run on the port.

- The cold tier: either package compacts a durable log into column
  blocks and a manifest that the other reads back column for column;
  both skip a torn or corrupt tail the same way and count it. Exact.
- Replay: the same cold tier, the same weights (JAX params through
  `convert.params_from_numpy`), `lstm-stream` at window 16 and hidden 8
  in float32 with float32 score readback, through each package's
  `SharedScoringPool`: the score tables agree within 1e-2 (the streaming
  tests' tolerance; in float32 the two agree far closer), and `compare`
  / `guard_swap` reach the same decisions.
- The port alone: double replay is byte-identical, replay scores what
  live scoring scored, and the version fence aborts a replay that a
  hot-swap lands in.
"""

import asyncio
import glob
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.domain import batch as jbatch
from sitewhere_tpu.history import replay as jreplay
from sitewhere_tpu.history import store as jstore
from sitewhere_tpu.kernel.metrics import MetricsRegistry as JMetrics
from sitewhere_tpu.models import build_model as jax_build
from sitewhere_tpu.persistence import durable as jdurable
from sitewhere_tpu.persistence.telemetry import TelemetryStore as JTelemetry
from sitewhere_tpu.scoring.pool import PoolConfig as JPoolConfig
from sitewhere_tpu.scoring.pool import SharedScoringPool as JPool
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.domain import batch as tbatch
from sitewhere_tpu_torch.history import replay as treplay
from sitewhere_tpu_torch.history import store as tstore
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.persistence import durable as tdurable
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

JAX = SimpleNamespace(batch=jbatch, store=jstore, durable=jdurable)
PORT = SimpleNamespace(batch=tbatch, store=tstore, durable=tdurable)
WAYS = {"jax-to-port": (JAX, PORT), "port-to-jax": (PORT, JAX)}
T0 = 1_700_000_000.0
DEVICES, W, H = 256, 16, 8
SCORE_ATOL = 1e-2


def build_corpus(pkg, root, n_batches=8, per_batch=512, seed=7,
                 segment_bytes=1 << 14):
    """`n_batches` measurement batches over DEVICES with strictly
    increasing ts, in a durable log of small segments."""
    rng = np.random.default_rng(seed)
    log = pkg.durable.SegmentLog(str(root), segment_bytes=segment_bytes)
    for i in range(n_batches):
        n = per_batch
        dev = rng.integers(0, DEVICES, n).astype(np.uint32)
        ts = T0 + i * n * 0.05 + np.arange(n) * 0.05
        val = rng.normal(20.0, 5.0, n).astype(np.float32)
        log.append(pkg.durable.RT_MEASUREMENTS, pkg.batch.MeasurementBatch(
            pkg.batch.BatchContext("acme"), dev, np.zeros(n, np.uint16),
            val, ts).encode())
    log.close()
    return log


def read_all(store) -> tuple:
    out = [[] for _ in range(5)]
    for w, cols in store.read_range():
        out[0].append(np.full(len(cols["ts"]), w))
        for i, k in enumerate(("device_index", "mtype", "value", "ts")):
            out[i + 1].append(np.asarray(cols[k]))
    return tuple(np.concatenate(c) for c in out)


@pytest.mark.parametrize("way", list(WAYS))
def test_cold_tier_reads_back_in_the_other_package(tmp_path, way):
    """Blocks and manifest written by one package's compactor (two
    passes, flush-split windows) read back equal columns, windows and
    stats in the other."""
    src, dst = WAYS[way]
    log = build_corpus(src, tmp_path / "events")
    seqs = [seq for seq, _ in log._segments()]
    hist = str(tmp_path / "history")
    store = src.store.EventHistoryStore(hist, source=log, window_s=30.0,
                                        block_events=300)
    store.compact(through_seq=seqs[len(seqs) // 2])
    store.compact(through_seq=log._seq)
    got = dst.store.EventHistoryStore(hist, window_s=30.0)
    assert got.windows() == store.windows()
    assert got.stats() == store.stats()
    assert got.stats()["events"] == 8 * 512
    for a, b in zip(read_all(got), read_all(store)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    # log order within each window, windows ascending
    assert (np.diff(read_all(got)[4]) > 0).all()


def test_both_compactors_write_the_same_bytes(tmp_path):
    for name, pkg in (("jax", JAX), ("port", PORT)):
        log = build_corpus(pkg, tmp_path / name / "events")
        pkg.store.EventHistoryStore(
            str(tmp_path / name / "history"), source=log, window_s=30.0,
            block_events=300).compact(through_seq=log._seq)
    blocks = {name: [open(p, "rb").read() for p in sorted(glob.glob(
        str(tmp_path / name / "history" / "blocks-*.blk")))]
        for name in ("jax", "port")}
    assert blocks["jax"] == blocks["port"] and blocks["jax"]


@pytest.mark.parametrize("fault", ["torn", "crc"])
def test_torn_or_corrupt_segment_skipped_and_counted_alike(tmp_path, fault):
    reports = {}
    for name, pkg in (("jax", JAX), ("port", PORT)):
        log = build_corpus(pkg, tmp_path / name / "events")
        segs = [p for p in sorted(glob.glob(
            str(tmp_path / name / "events" / "*"))) if os.path.getsize(p)]
        with open(segs[-1], "r+b") as f:
            if fault == "torn":
                f.truncate(os.path.getsize(segs[-1]) - 7)
            else:
                f.seek(9 + 100)
                byte = f.read(1)
                f.seek(-1, os.SEEK_CUR)
                f.write(bytes([byte[0] ^ 0xFF]))
        store = pkg.store.EventHistoryStore(
            str(tmp_path / name / "history"), source=log, window_s=30.0)
        rep = store.compact(through_seq=log._seq)
        rep.pop("elapsed_s")
        reports[name] = (rep, store.stats())
    assert reports["port"] == reports["jax"]
    assert reports["port"][0]["tail_skips"] == 1
    assert reports["port"][0]["events"] < 8 * 512


def test_restart_mid_compaction_resumes_idempotently(tmp_path):
    log = build_corpus(PORT, tmp_path / "events")
    seqs = [seq for seq, _ in log._segments()]
    mid = seqs[len(seqs) // 2]
    hist = str(tmp_path / "history")
    rep1 = tstore.EventHistoryStore(hist, source=log).compact(through_seq=mid)
    store2 = tstore.EventHistoryStore(hist, source=log)
    assert store2.compacted_through_seq == mid
    rep2 = store2.compact(through_seq=log._seq)
    assert rep1["events"] + rep2["events"] == 8 * 512
    assert store2.compact(through_seq=log._seq) == {
        "segments": 0, "events": 0, "blocks": 0}


# -- replay ------------------------------------------------------------------

def _params():
    model = jax_build("lstm-stream", window=W, hidden=H,
                      compute_dtype=jnp.float32)
    return jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(3)))


def _port_pool():
    model = build_model("lstm-stream", device="cpu", window=W, hidden=H,
                        compute_dtype=torch.float32)
    return SharedScoringPool(model, MetricsRegistry(), PoolConfig(
        batch_buckets=(64, 256), batch_window_ms=1.0,
        score_dtype="float32"), device="cpu")


def _jax_pool():
    model = jax_build("lstm-stream", window=W, hidden=H,
                      compute_dtype=jnp.float32)
    return JPool(model, JMetrics(), JPoolConfig(
        batch_buckets=(64, 256), batch_window_ms=1.0, score_dtype="float32"))


def _cold_tier(tmp_path):
    log = build_corpus(PORT, tmp_path / "events")
    store = tstore.EventHistoryStore(str(tmp_path / "history"), source=log,
                                     window_s=30.0)
    store.compact(through_seq=log._seq)
    return store, jstore.EventHistoryStore(str(tmp_path / "history"),
                                           window_s=30.0)


async def _replay(pkg_replay, pool, store, params, telemetry):
    async def sink(_scored):
        return None

    try:
        engine = pkg_replay.ReplayEngine(pool)
        got = pkg_replay.ScoreCollector()
        report = await engine.replay("acme", store, 6.0, params=params,
                                     collect=got)
        live = pool.register("acme", telemetry(), 6.0, sink, params=params)
        bad = {k: {n: v + 0.5 for n, v in leaf.items()}
               for k, leaf in params.items()}
        try:
            await engine.guard_swap(live, store, bad, max_divergence=0.05)
            refused = None
        except pkg_replay.DivergenceGateError as exc:
            refused = exc.report
        _, promoted = await engine.guard_swap(
            live, store, {k: dict(v) for k, v in params.items()},
            max_divergence=0.05)
        return report, got.table(), refused, promoted
    finally:
        pool.close()


def test_replay_matches_jax_replay(run, tmp_path):
    """The same cold tier and weights through both packages' replay:
    every event scored once in both, score tables within 1e-2, and the
    shadow gate refuses the perturbed candidate and promotes the
    identical one in both."""
    tstore_, jstore_ = _cold_tier(tmp_path)
    np_params = _params()
    got = run(_replay(treplay, _port_pool(), tstore_,
                      params_from_numpy(np_params, "cpu"), TelemetryStore))
    want = run(_replay(jreplay, _jax_pool(), jstore_,
                       jax.tree.map(jnp.asarray, np_params), JTelemetry))
    for key in ("events", "windows", "scored", "versions"):
        assert got[0][key] == want[0][key]
    assert got[0]["events"] == 8 * 512
    (gd, gts, gs, ga), (wd, wts, ws, wa) = got[1], want[1]
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gts, wts)
    np.testing.assert_allclose(gs, ws, atol=SCORE_ATOL)
    assert np.count_nonzero(gs) > 1000  # the scoring floor is passed
    assert np.count_nonzero(ga != wa) <= 2
    for refused in (got[2], want[2]):
        assert refused is not None and refused["promoted"] is False
        assert refused["max_abs"] > 0.05
    assert abs(got[2]["max_abs"] - want[2]["max_abs"]) <= SCORE_ATOL
    for promoted in (got[3], want[3]):
        assert promoted["promoted"] and promoted["max_abs"] == 0.0
        assert promoted["version"] == 1


def test_double_replay_byte_identical_and_live_equal(run, tmp_path):
    """Two replays of one range give byte-identical tables, equal to
    the scores the same records got through live admission."""
    store, _ = _cold_tier(tmp_path)
    params = params_from_numpy(_params(), "cpu")
    corpus = list(tdurable.SegmentLog(str(tmp_path / "events")).replay())

    async def main():
        pool = _port_pool()
        try:
            engine = treplay.ReplayEngine(pool, metrics=MetricsRegistry())
            tables = []
            for _ in range(2):
                c = treplay.ScoreCollector()
                r = await engine.replay("acme", store, 6.0, params=params,
                                        collect=c)
                assert r["events"] == r["scored"] == 8 * 512
                tables.append(c.table())
            live = treplay.ScoreCollector()
            slot = pool.register("acme", TelemetryStore(), 6.0, live,
                                 params=params)
            for _, payload in corpus:
                slot.admit(tbatch.MeasurementBatch.decode(
                    payload, tbatch.BatchContext("acme")))
                while not slot.idle:
                    slot.flush_nowait()
                    await asyncio.sleep(0.002)
            tables.append(live.table())
        finally:
            pool.close()
        return tables

    first, second, live = run(main())
    for a, b in zip(first, second):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(first, live):
        assert a.tobytes() == b.tobytes()


def test_fence_aborts_on_a_midreplay_swap_and_frees_the_slot(run, tmp_path):
    store, _ = _cold_tier(tmp_path)
    assert len(store.windows()) >= 2

    class SwapAfterFirstWindow:
        def __init__(self, inner, slot):
            self.inner, self.slot = inner, slot

        def read_range(self, since=None, until=None):
            for i, item in enumerate(self.inner.read_range(since, until)):
                yield item
                if i == 0:
                    self.slot.swap_params(
                        self.slot.pool.stack.get_params("acme"))

    async def sink(_scored):
        return None

    async def main():
        pool = _port_pool()
        try:
            slot = pool.register("acme", TelemetryStore(), 6.0, sink)
            engine = treplay.ReplayEngine(pool)
            with pytest.raises(treplay.ReplayFenceError):
                await engine.replay("acme", SwapAfterFirstWindow(store, slot),
                                    6.0, fence=slot)
            assert all(not t.startswith("tenant-0.replay:")
                       for t in pool.tenants)
        finally:
            pool.close()

    run(main())


def test_replay_metrics(run, tmp_path):
    metrics = MetricsRegistry()
    log = build_corpus(PORT, tmp_path / "events")
    store = tstore.EventHistoryStore(str(tmp_path / "history"), source=log,
                                     window_s=30.0, metrics=metrics)
    store.compact(through_seq=log._seq)

    async def main():
        pool = _port_pool()
        try:
            await treplay.ReplayEngine(pool, metrics=metrics).replay(
                "acme", store, 6.0)
        finally:
            pool.close()

    run(main())
    snap = metrics.snapshot()
    assert snap["history.compactions"] == 1
    assert snap["history.replay_events"] == 8 * 512
    assert snap["history.replay_rate"] > 0
