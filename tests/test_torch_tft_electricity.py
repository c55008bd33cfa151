"""The TFT (`models/tft.py`) as the benchmark's `tft-flood` cell serves it:
through the megabatch pool's windowed stacked ring under `vmap`, held
against the benchmark's plain reference (`swxbench/reference/tft.py`),
which is written from the paper's equations and imports nothing of the
port. Also the reference's operation count, the model's profiler ranges,
the pool's window-row counters and its hold of a slow scorer's partial
buckets. CPU only, small shapes but for one forward at the published
widths.

Tolerances. Float32 products: the pool and the reference do the same
float32 operations, only in other shapes (the pool's batched `vmap`
products against the reference's plain ones), so they differ by float32
rounding, held to 1e-4 of max(1, |score|). Bfloat16 products: both round
every product to bfloat16 at the same places, and a float32 sum that
lands on the other side of a bfloat16 rounding boundary moves that
product by one bfloat16 ulp (2^-8 relative); such a step can reach a
quantile, and a quantile one ulp off moves the score by up to about
1e-2 of an interval's half-width in σ units, so 2e-2.
"""

import asyncio

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.kernel import tracing
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from swxbench.reference import tft as ref

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

SMALL = {"window": 24, "horizon": 4, "hidden": 16, "heads": 4,
         "quantiles": [0.1, 0.5, 0.9]}
PUBLISHED = {"window": 192, "horizon": 24, "hidden": 160, "heads": 4,
             "quantiles": [0.1, 0.5, 0.9]}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DEVICES, TICKS, BUCKET = 40, 6, 64
STAGES = ["tft.select", "tft.seq2seq", "tft.attend"]


def _model(widths, dtype=torch.bfloat16):
    return build_model("tft", device="cpu", window=widths["window"],
                       horizon=widths["horizon"], hidden=widths["hidden"],
                       heads=widths["heads"], compute_dtype=dtype)


def _readings(seed: int, devices: int, ticks: int) -> np.ndarray:
    """[devices, ticks] float32: random walks with a spike or two."""
    rng = np.random.default_rng(seed)
    x = np.cumsum(rng.normal(0.0, 0.3, (devices, ticks)), axis=1)
    x += rng.normal(0.0, 1.0, (devices, ticks)) + 20.0
    x[rng.random((devices, ticks)) < 0.02] += 12.0
    return x.astype(np.float32)


def _gap(served: np.ndarray, want: np.ndarray) -> float:
    return float((np.abs(served.astype(np.float64) - want)
                  / np.maximum(1.0, np.abs(want))).max())


async def _serve(widths, dtype, seed, values, n_warm):
    """Every reading past the warm history through the pool, one tick a
    dispatch: (served scores [devices, ticks], the pool's metrics)."""
    devices = values.shape[0]
    model = _model(widths, dtype)
    metrics = MetricsRegistry()
    pool = SharedScoringPool(
        model, metrics, PoolConfig(batch_buckets=(BUCKET,),
                                   batch_window_ms=1.0,
                                   score_dtype="float32"), device="cpu")
    store = TelemetryStore(history=64, initial_devices=devices)
    dev = np.arange(devices, dtype=np.uint32)
    for j in range(n_warm):
        store.append_values(dev, values[:, j], np.full(devices, 60.0 * j))
    got: list = []

    async def deliver(scored):
        got.append(scored)

    pool.register("t0", store, 6.0, deliver,
                  params=ref.make_params(widths, seed, "cpu"))
    try:
        while not pool.ready:
            await asyncio.sleep(0.01)
        for j in range(n_warm, values.shape[1]):
            pool.admit("t0", MeasurementBatch(
                BatchContext(tenant_id="t0", source="test"), dev,
                np.zeros(devices, np.uint16), values[:, j],
                np.full(devices, 60.0 * j)))
            pool.flush_nowait()
            await pool.drain(timeout=60.0)
    finally:
        pool.close()
    served = np.full((devices, values.shape[1] - n_warm), np.nan, np.float32)
    for b in got:
        col = np.rint(b.ts / 60.0).astype(np.int64) - n_warm
        served[b.device_index.astype(np.int64), col] = b.score
    return served, metrics


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [190001, 190002, 2**31 + 19])
def test_the_pool_serves_the_reference(seed, dtype):
    w = SMALL["window"]
    n_warm = w + 4
    values = _readings(seed, DEVICES, n_warm + TICKS)
    served, _ = asyncio.run(_serve(SMALL, dtype, seed, values, n_warm))
    params = ref.make_params(SMALL, seed, "cpu")
    want = ref.scores(params, SMALL, torch.from_numpy(values), n_warm,
                      dtype).numpy()
    assert not np.isnan(served).any()
    assert want.shape == (DEVICES, TICKS) and (want > 0).any()
    assert _gap(served, want) <= TOL[dtype], (served, want)


def test_one_forward_at_the_published_widths():
    seed = 190011
    params = ref.make_params(PUBLISHED, seed, "cpu")
    x = torch.from_numpy(_readings(seed, 2, PUBLISHED["window"]))
    valid = torch.ones_like(x, dtype=torch.bool)
    with torch.no_grad():
        got = _model(PUBLISHED).score(params, x, valid).numpy()
        want = ref.window_scores(params, PUBLISHED, x, torch.bfloat16).numpy()
    assert got.shape == (2,)
    assert _gap(got, want) <= TOL[torch.bfloat16], (got, want)


def test_the_operation_count():
    # by hand at W=24, H=4 (20 context steps), d=16, 4 heads of 4, 3
    # quantiles, in multiply-adds:
    static = 4 * 16 * 16 + 3 * 16 * 16          # GRN(d, d); c_s's 3 uses
    past = 20 * (4 * 16                          # embeddings
                 + 64 * 16 + 16 * 4 + 4 * 8 + 64 * 4   # selection GRN
                 + 4 * 4 * 16 * 16)              # one GRN an input
    known = 4 * (2 * 16 + 32 * 16 + 16 * 2 + 2 * 4 + 32 * 2
                 + 2 * 4 * 16 * 16)
    lstm = 24 * 2 * 16 * 64                      # x·Wx and h·Wh a step
    seq = 24 * (2 * 16 * 16 + 4 * 16 * 16 + 16 * 16 + 16 * 4)  # skip, enrich, K, V
    attention = 2 * 4 * 4 * 24 * 4               # QKᵀ and AV, every key
    tail = 4 * (16 * 16 + 4 * 16 + 2 * 16 * 16 + 4 * 16 * 16
                + 2 * 16 * 16 + 16 * 3)
    macs = static + past + known + lstm + seq + attention + tail
    assert macs == 229_728
    assert ref.flops_per_event(SMALL) == 2 * macs

    # the products the program runs, counted by torch on one window
    from torch.utils.flop_counter import FlopCounterMode

    model = _model(SMALL, torch.float32)
    x = torch.from_numpy(_readings(1, 1, SMALL["window"]))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model.score(ref.make_params(SMALL, 1, "cpu"), x,
                    torch.ones_like(x, dtype=torch.bool))
    assert counter.get_total_flops() == 2 * macs

    n_params = sum(t.numel() for t in torch.utils._pytree.tree_leaves(
        model.init()))
    assert ref.param_count(SMALL) == n_params
    flops, nbytes = ref.counts(SMALL, 1000)
    assert flops == 1000 * 2 * macs
    assert nbytes == 1000 * (4 * 24 + 4) + 2 * n_params
    assert ref.flops_per_event(PUBLISHED) == 2 * 175_146_688


def test_the_stage_ranges_open_only_under_a_profiler(monkeypatch):
    opened: list = []
    real = tracing.profiler_range

    def spy(name):
        rf = real(name)
        opened.append((name, rf is not None))
        return rf

    monkeypatch.setattr(tracing, "profiler_range", spy)
    seed, n_warm = 190021, SMALL["window"] + 4
    values = _readings(seed, 8, n_warm + 1)
    asyncio.run(_serve(SMALL, torch.bfloat16, seed, values, n_warm))
    # warm-up and the one dispatch opened none of them
    assert [n for n, _ in opened if n.startswith("tft.")][:3] == STAGES
    assert not any(live for n, live in opened if n.startswith("tft."))

    from torch.profiler import ProfilerActivity, profile

    opened.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        asyncio.run(_serve(SMALL, torch.bfloat16, seed, values, n_warm))
    assert all(live for n, live in opened if n.startswith("tft."))
    dispatches = [e for e in prof.events() if e.name == "scoring.dispatch"]
    assert len(dispatches) == 1
    inside = sorted((e for e in prof.events() if e.name in STAGES
                     and e.time_range.start >= dispatches[0].time_range.start
                     and e.time_range.end <= dispatches[0].time_range.end),
                    key=lambda e: e.time_range.start)
    assert [e.name for e in inside] == STAGES
    # each stage ran work of its own
    assert all(e.cpu_children for e in inside)


def test_the_window_row_counters_after_a_padded_dispatch():
    seed, n_warm = 190031, SMALL["window"] + 4
    values = _readings(seed, DEVICES, n_warm + 2)
    _, metrics = asyncio.run(_serve(SMALL, torch.float32, seed, values,
                                    n_warm))
    assert metrics.counter("scoring.dispatches").value == 2
    assert metrics.counter("scoring.window_rows").value == 2 * DEVICES
    assert (metrics.counter("scoring.window_pad_rows").value
            == 2 * (BUCKET - DEVICES))


@pytest.mark.parametrize("slow", [True, False], ids=["slow", "fast"])
def test_a_slow_dispatch_holds_a_partial_bucket_for_the_card(slow):
    """Dispatches that hold the loop longer than the megabatch window
    (the TFT's, at its widths) make a partial bucket wait one such hold
    to fill, from its first admission or from the flush that left it
    behind; a full bucket goes at once. Dispatches inside the window hold
    nothing back."""
    import time

    model = _model(SMALL, torch.float32)
    window_s = 0.001 if slow else 0.2
    hold_s = 0.05
    if slow:
        score = model.score

        def slow_score(params, x, valid):
            time.sleep(hold_s)
            return score(params, x, valid)

        model.score = slow_score
    devices = 3 * BUCKET
    values = _readings(1, devices, SMALL["window"] + 4)

    async def drive():
        pool = SharedScoringPool(
            model, MetricsRegistry(),
            PoolConfig(batch_buckets=(16, BUCKET),
                       batch_window_ms=1e3 * window_s,
                       score_dtype="float32"), device="cpu")
        store = TelemetryStore(history=64, initial_devices=devices)
        dev = np.arange(devices, dtype=np.uint32)
        for j in range(values.shape[1]):
            store.append_values(dev, values[:, j], np.full(devices, 60.0 * j))

        async def deliver(scored):
            pass

        pool.register("t0", store, 6.0, deliver)
        lo = [0]

        def admit(n):
            a, b = lo[0], lo[0] + n
            lo[0] = b
            pool.admit("t0", MeasurementBatch(
                BatchContext(tenant_id="t0", source="test"), dev[a:b],
                np.zeros(n, np.uint16), values[a:b, -1], np.full(n, 1e6)))

        held = []
        try:
            while not pool.ready:
                await asyncio.sleep(0.01)
            # no await between an admission and its flush: the pool's own
            # flusher stays out, and the windows close by the clock alone
            for _ in range(4):          # the holds the pool judges by
                admit(8)
                time.sleep(window_s + 0.001)
                assert pool.flush_nowait()
            admit(8)
            time.sleep(window_s + 0.001)
            held.append(not pool.flush_nowait())     # waits one hold
            if slow:
                assert pool.flush_wait_s > 0.5 * hold_s
                admit(BUCKET)                        # a full bucket goes
                assert pool.flush_nowait() and pool._total_pending == 0
                admit(BUCKET)                        # full, and a partial
                admit(8)                             # remainder left behind
                assert pool.flush_nowait() and pool._total_pending == 8
                held.append(not pool.flush_nowait())
                time.sleep(min(pool._dispatch_holds) + 0.001)
                held.append(not pool.flush_nowait())
            await pool.drain(timeout=30.0)
            return held, pool.dispatch_count
        finally:
            pool.close()

    held, dispatches = asyncio.run(drive())
    # slow: the 8 held, then it and the full bucket as two rounds of one
    # flush (a take ends at a batch's edge), a full bucket whose remainder
    # waits, gone after one hold; fast: never held
    assert (held, dispatches) == (([True, True, False], 8) if slow
                                  else ([False], 5))
