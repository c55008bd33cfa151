"""K2, the streaming step's CUDA kernel (`ops/lstm_stream_kernel.py`), on
the CPU: the wrapper's checks; the CPU path held bit for bit against the
plain chain as it stood before K2 (a copy below), for the dedicated, the
stacked and the sparse rings; the rings' choice of K2, made once when a
ring is built — exactly where `model.fused` holds and the state is on the
card — with the C entry replaced by a recorder, so that nothing launches;
and the counter `scoring.stream_kernel_dispatches` in the pool and the
session, which follows the launches. The kernel itself runs only on the
card (`chip_smoke.py`'s `stream-kernel` phase)."""

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from sitewhere_tpu_torch.domain.batch import BatchContext, MeasurementBatch
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.ops import lstm_stream_kernel as k2
from sitewhere_tpu_torch.parallel import TenantStack
from sitewhere_tpu_torch.parallel.mesh import make_mesh
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.scoring.stream import (
    MeshRing,
    StackedStreamingRing,
    StreamingRing,
    _sparse_k,
    sparse_select,
    streaming_step_plain,
)
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

W, H = 16, 16
DEVICES, BUCKET = 48, 32


def _model(**cfg):
    cfg = {"window": W, "hidden": H, **cfg}
    return build_model("lstm-stream", device="cpu", **cfg)


def _windows(rng, n):
    x = rng.normal(20.0, 2.0, (n, W)).astype(np.float32)
    count = rng.integers(0, W + 1, n)
    return x, count


# -- the chain as it stood before K2 (the reference of the CPU path) --------


def _reference_step(model, out_dtype=None, stacked=False):
    step_score = (torch.func.vmap(model.step_score) if stacked
                  else model.step_score)

    def step(params, state, dev, v):
        if stacked:
            stride = next(iter(state.values())).shape[1]
            tenant = torch.arange(dev.shape[0], device=dev.device)
            rows = (dev + stride * tenant[:, None]).reshape(-1)
            state = {k: leaf.view(-1, *leaf.shape[2:])
                     for k, leaf in state.items()}
        else:
            rows = dev
        got = {k: leaf[rows].reshape(*dev.shape, *leaf.shape[1:])
               for k, leaf in state.items()}
        scores, new_rows = step_score(params, got, v)
        for k, leaf in state.items():
            leaf.index_put_((rows,), new_rows[k].reshape(-1, *leaf.shape[1:]))
        return scores if out_dtype is None else scores.to(out_dtype)

    return step


def _same(got, want) -> None:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


def _same_state(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


def _clone(state: dict) -> dict:
    return {k: leaf.clone() for k, leaf in state.items()}


# -- the wrapper's checks ---------------------------------------------------


def _inputs(t=2, b=8, rows=9, hidden=8):
    """Valid stacked inputs of a [t, b] dispatch."""
    g = 4 * hidden
    state = {"pred": torch.zeros(t, rows), "mean": torch.zeros(t, rows),
             "var": torch.ones(t, rows),
             "count": torch.zeros(t, rows, dtype=torch.int32),
             "h0": torch.zeros(t, rows, hidden),
             "c0": torch.zeros(t, rows, hidden)}
    params = {"lstm0": {"wx": torch.zeros(t, 1, g),
                        "wh": torch.zeros(t, hidden, g),
                        "b": torch.zeros(t, g)},
              "head": {"w": torch.zeros(t, hidden, 1), "b": torch.zeros(t, 1)}}
    dev = torch.zeros(t, b, dtype=torch.int32)
    v = torch.zeros(t, b)
    return params, state, dev, v


def _set(tree: dict, path: str, value) -> None:
    *head, last = path.split(".")
    for key in head:
        tree = tree[key]
    tree[last] = value


CHECK_CASES = {
    "ids int64": ("dev", lambda p, s, d, v: d.long(), "int32"),
    "values float64": ("v", lambda p, s, d, v: v.double(), "float32"),
    "values shape": ("v", lambda p, s, d, v: v[:, :4], "alike"),
    "ids rank 3": ("dev", lambda p, s, d, v: d[None], "alike"),
    "ids strided": ("dev", lambda p, s, d, v: torch.zeros(
        d.shape[1], d.shape[0], dtype=torch.int32).T, "contiguous"),
    "hidden 12": ("state.h0", lambda p, s, d, v: torch.zeros(2, 9, 12),
                  "hidden in"),
    "count float": ("state.count", lambda p, s, d, v: torch.zeros(2, 9),
                    "count must be"),
    "c0 strided": ("state.c0", lambda p, s, d, v: torch.zeros(
        2, 8, 9).transpose(1, 2), "c0 must be contiguous"),
    "c0 rows": ("state.c0", lambda p, s, d, v: torch.zeros(2, 10, 8),
                "c0 must be"),
    "wh transposed": ("params.lstm0.wh", lambda p, s, d, v: torch.zeros(
        2, 32, 8), "lstm0.wh must be"),
    "head b unstacked": ("params.head.b", lambda p, s, d, v: torch.zeros(1),
                         "head.b must be"),
    "b float64": ("params.lstm0.b", lambda p, s, d, v: torch.zeros(
        2, 32, dtype=torch.float64), "lstm0.b must be"),
    "two layers": ("state.h1", lambda p, s, d, v: torch.zeros(2, 9, 8),
                   "single-layer"),
    "param elsewhere": ("params.head.w", lambda p, s, d, v: torch.zeros(
        2, 8, 1, device="meta"), "is on meta"),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
def test_check_refuses(case):
    where, make, match = CHECK_CASES[case]
    params, state, dev, v = _inputs()
    value = make(params, state, dev, v)
    if where == "dev":
        dev = value
    elif where == "v":
        v = value
    elif where.startswith("state."):
        state[where[6:]] = value
    else:
        _set(params, where[7:], value)
    with pytest.raises(ValueError, match=match):
        k2.check(params, state, dev, v, torch.float16)


def test_check_takes_both_layouts_and_refuses_score_type():
    params, state, dev, v = _inputs(t=3, b=5, rows=7, hidden=16)
    assert k2.check(params, state, dev, v, None) == (3, 5, 7, 16)
    for dtype in k2.SCORE_KINDS:
        assert k2.check(params, state, dev, v, dtype) == (3, 5, 7, 16)
    with pytest.raises(ValueError, match="the kernel writes"):
        k2.check(params, state, dev, v, torch.float64)
    # the dedicated ring's layout: no tenant axis
    one = lambda x: x[0].contiguous()  # noqa: E731
    params1 = {g: {k: one(x) for k, x in d.items()}
               for g, d in params.items()}
    state1 = {k: one(x) for k, x in state.items()}
    assert k2.check(params1, state1, one(dev), one(v), None) == (1, 5, 7, 16)
    with pytest.raises(ValueError, match="does not match"):
        k2.check(params1, state, one(dev), one(v), None)


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_no_step_on_another_device(recorder, where):
    params, state, dev, v = _inputs()
    to = lambda x: x.to(where)  # noqa: E731
    params = {g: {k: to(x) for k, x in d.items()} for g, d in params.items()}
    state = {k: to(x) for k, x in state.items()}
    before = k2.launches
    with pytest.raises(ValueError, match="takes tensors on the card"):
        k2.lstm_stream_step(params, state, to(dev), to(v), window=W,
                            min_count=8, score_clip=50.0, out_dtype=None)
    assert recorder.calls == [] and k2.launches == before


# -- the CPU path, bit for bit against the chain as it was -----------------


def _dedicated_ring(model, params, rng, sparse):
    ring = StreamingRing(model, capacity=DEVICES, score_dtype="float16",
                         sparse_threshold=0.5 if sparse else None,
                         device="cpu")
    ring.bind_params(params)
    ring.load(*_windows(rng, DEVICES))
    return ring


def _stacked_ring(model, stack, rng, sparse):
    ring = StackedStreamingRing(model, stack.capacity, device_cap=DEVICES,
                                score_dtype="float16", sparse=sparse,
                                device="cpu")
    for tid, slot in stack.slots.items():
        ring.load_tenant(slot, *_windows(rng, DEVICES),
                         stack.get_params(tid))
    return ring


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_cpu_path_bit_identical_dedicated(sparse):
    model = _model()
    assert model.fused  # the configuration routes through the wrapper
    rng = np.random.default_rng(11)
    params = model.init(torch.Generator().manual_seed(3))
    ring = _dedicated_ring(model, params, rng, sparse)
    want_state = _clone(ring.state)
    dense = _reference_step(model, None if sparse else ring.score_dtype)
    for _ in range(6):
        n = int(rng.integers(1, BUCKET + 1))
        dev = rng.choice(DEVICES, n, replace=False).astype(np.int32)
        v = rng.normal(20.0, 4.0, n).astype(np.float32)
        got = ring.update_and_score(model, params, dev, v, BUCKET)
        pdev = np.full(BUCKET, ring.capacity, np.int64)
        pdev[:n] = dev
        pv = np.zeros(BUCKET, np.float32)
        pv[:n] = v
        pdev, pv = torch.from_numpy(pdev), torch.from_numpy(pv)
        want = dense(params, want_state, pdev, pv)
        if sparse:
            want = sparse_select(want, pdev, 0.5, _sparse_k(0, BUCKET),
                                 ring.capacity, ring.score_dtype)
            assert int(want[0]) > 0  # the threshold reports some
        _same(got, want)
        _same_state(ring.state, want_state)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_cpu_path_bit_identical_stacked(sparse):
    model = _model()
    rng = np.random.default_rng(12)
    stack = TenantStack(model, device="cpu")
    for i, tid in enumerate(("a", "b", "c")):
        stack.add_tenant(tid, model.init(torch.Generator().manual_seed(20 + i)))
    ring = _stacked_ring(model, stack, rng, sparse)
    want_state = _clone(ring.state)
    dense = _reference_step(model, None if sparse else ring.score_dtype,
                            stacked=True)
    thresholds = np.array([0.5, 1.0, 0.25, np.inf], np.float32)[:ring.t_cap]
    for _ in range(6):
        dev = np.full((ring.t_cap, BUCKET), ring.device_cap, np.int32)
        v = np.zeros((ring.t_cap, BUCKET), np.float32)
        for slot in stack.slots.values():  # a partly filled row each
            n = int(rng.integers(1, BUCKET + 1))
            dev[slot, :n] = rng.choice(DEVICES, n, replace=False)
            v[slot, :n] = rng.normal(20.0, 4.0, n)
        got = ring.update_and_score(model, stack.stacked, dev, v,
                                    thresholds=thresholds)
        pdev = torch.from_numpy(dev.astype(np.int64))
        want = dense(stack.stacked, want_state, pdev, torch.from_numpy(v))
        if sparse:
            want = sparse_select(want, pdev,
                                 torch.from_numpy(thresholds)[:, None],
                                 _sparse_k(0, BUCKET), ring.device_cap,
                                 ring.score_dtype)
            assert int(want[0].sum()) > 0
        _same(got, want)
        _same_state(ring.state, want_state)


# -- the choice of K2, with the C entry replaced by a recorder ---------------


class Recorder:
    """Stands in for the C entry: records each call's arguments and zeroes
    the scores the kernel would write; launches nothing."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        t, b, scores, kind = args[2], args[3], args[16], args[17]
        ctypes.memset(scores, 0, t * b * (4 if kind == 0 else 2))
        return 0


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(k2, "_c_entry", lambda: rec)
    return rec


@pytest.fixture
def card(monkeypatch, recorder):
    """The CPU state taken for the card's: `on_card` answers yes, and the
    launch's device context and stream are stand-ins."""
    monkeypatch.setattr(k2, "on_card", lambda device: True)
    monkeypatch.setattr(k2, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return recorder


CONFIGS = {"fused": ({}, True),
           "hidden 12": ({"hidden": 12}, False),
           "two layers": ({"layers": 2}, False),
           "float32 products": ({"compute_dtype": torch.float32}, False)}


def _one_dispatch(kind: str, model, rng):
    """One dispatch through a ring of `kind` on the CPU; returns the ring
    and the dispatch's (dev, v) columns."""
    if kind == "dedicated":
        params = model.init(torch.Generator().manual_seed(1))
        ring = _dedicated_ring(model, params, rng, False)
        dev = rng.choice(DEVICES, 20, replace=False).astype(np.int32)
        ring.update_and_score(model, params, dev,
                              np.ones(20, np.float32), BUCKET)
        return ring, params
    stack = TenantStack(model, device="cpu")
    stack.add_tenant("a")
    stack.add_tenant("b")
    ring = _stacked_ring(model, stack, rng, False)
    dev = np.full((ring.t_cap, BUCKET), ring.device_cap, np.int32)
    dev[:, :10] = np.arange(10)
    ring.update_and_score(model, stack.stacked, dev,
                          np.ones(dev.shape, np.float32))
    return ring, stack.stacked


@pytest.mark.parametrize("kind", ["dedicated", "stacked"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_ring_takes_kernel_only_fused_on_card(card, kind, config):
    overrides, fused = CONFIGS[config]
    model = _model(**overrides)
    assert model.fused == fused
    before = k2.launches
    ring, params = _one_dispatch(kind, model, np.random.default_rng(5))
    assert len(card.calls) == int(fused)
    assert k2.launches - before == int(fused)
    if not fused:
        return
    (args,) = card.calls
    state = ring.state
    t = 1 if kind == "dedicated" else ring.t_cap
    rows = ring.capacity + 1 if kind == "dedicated" else ring.device_cap + 1
    assert args[2:4] == (t, BUCKET)
    assert args[4:10] == tuple(state[k].data_ptr() for k in k2.STATE_LEAVES)
    assert args[10] == rows
    assert args[11:16] == (params["lstm0"]["wx"].data_ptr(),
                           params["lstm0"]["wh"].data_ptr(),
                           params["lstm0"]["b"].data_ptr(),
                           params["head"]["w"].data_ptr(),
                           params["head"]["b"].data_ptr())
    assert args[17:21] == (k2.SCORE_KINDS[torch.float16], H, W,
                           model.min_history)
    assert args[21] == pytest.approx(model.cfg.score_clip)


@pytest.mark.parametrize("kind", ["dedicated", "stacked"])
def test_ring_on_cpu_never_launches(recorder, kind):
    model = _model()
    before = k2.launches
    _one_dispatch(kind, model, np.random.default_rng(6))
    assert recorder.calls == [] and k2.launches == before


@pytest.mark.parametrize("on", ["card", "cpu"])
def test_mesh_ring_takes_kernel_in_every_shard(monkeypatch, recorder, on):
    if on == "card":
        monkeypatch.setattr(k2, "on_card", lambda device: True)
        monkeypatch.setattr(k2, "_stream", lambda device: 0)
        monkeypatch.setattr(torch.cuda, "device",
                            lambda device: contextlib.nullcontext())
    model = _model()
    mesh = make_mesh(data=2, model=2, devices=["cpu"] * 4)

    def make(rows, cap, device, dtype):
        return StackedStreamingRing(model, rows, device_cap=cap,
                                    score_dtype=dtype, device=device)

    ring = MeshRing(mesh, make, 4, device_cap=32)
    stack = TenantStack(model, device="cpu")
    for tid in "abcd":
        stack.add_tenant(tid)
    dev = np.tile(np.arange(8, dtype=np.int32)[None], (4, 1))
    ring.update_and_score(model, stack.stacked, dev,
                          np.ones(dev.shape, np.float32))
    # one launch a shard ring: two model shards × two column blocks
    assert len(recorder.calls) == (4 if on == "card" else 0)


# -- the counter ---------------------------------------------------------------


def _store(n: int, seed: int, tid: str) -> tuple:
    store = TelemetryStore(history=64, initial_devices=n)
    sim = DeviceSimulator(SimConfig(num_devices=n, seed=seed), tenant_id=tid)
    for k in range(W + 4):
        store.append_measurements(sim.tick(t=60.0 * k)[0])
    return store, sim


# "card, plain step": the ring on the card, its step swapped for the plain
# chain after it was built; the counter follows the launches, so it reads 0
COUNTER_CASES = ["card", "cpu", "card, plain step"]


@pytest.mark.parametrize("on", COUNTER_CASES)
def test_pool_counts_kernel_dispatches(request, run, recorder, on):
    if on != "cpu":
        request.getfixturevalue("card")

    async def main():
        metrics = MetricsRegistry()
        pool = SharedScoringPool(
            _model(), metrics, PoolConfig(batch_buckets=(32, 64),
                                          batch_window_ms=1.0),
            device="cpu")
        delivered = []

        async def deliver(scored):
            delivered.append(scored)

        sims = {}
        for i, tid in enumerate(("a", "b")):
            store, sims[tid] = _store(DEVICES, 30 + i, tid)
            pool.register(tid, store, 4.0, deliver)
        await wait_until(lambda: pool.ready, timeout=30.0)
        if on == "card, plain step":
            pool.ring._step = streaming_step_plain(
                pool.model, pool.ring.score_dtype, stacked=True)
        warm_calls = len(recorder.calls)
        for k in range(3):
            for tid, sim in sims.items():
                pool.admit(tid, sim.tick(t=6000.0 + 60.0 * k)[0])
            pool.flush_nowait()
            await wait_until(lambda k=k: len(delivered) >= 2 * (k + 1),
                             timeout=10.0)
        dispatches = metrics.counter("scoring.dispatches").value
        took = metrics.counter("scoring.stream_kernel_dispatches").value
        assert dispatches >= 3
        launched = len(recorder.calls) - warm_calls
        if on == "card":
            assert took == dispatches == launched
        else:
            assert took == 0 and launched == 0
        pool.close()

    run(main())


@pytest.mark.parametrize("on", COUNTER_CASES)
def test_session_counts_kernel_dispatches(request, run, recorder, on):
    if on != "cpu":
        request.getfixturevalue("card")

    async def main():
        store, sim = _store(DEVICES, 40, "t")
        metrics = MetricsRegistry()
        s = ScoringSession(_model(), store, metrics,
                           ScoringConfig(buckets=(32, 64), threshold=4.0),
                           device="cpu")
        s.warmup()
        if on == "card, plain step":
            s.ring._step = streaming_step_plain(s.model, s.ring.score_dtype)
        warm_calls = len(recorder.calls)
        dev = np.array([5, 9, 5, 7], np.uint32)  # two occurrence rounds
        s.admit(MeasurementBatch(BatchContext(tenant_id="t", source="x"), dev,
                                 np.zeros(4, np.uint16),
                                 np.full(4, 21.0, np.float32),
                                 np.full(4, 6000.0)))
        await s.flush()
        s.admit(sim.tick(t=6060.0)[0])
        await s.flush()
        dispatches = metrics.counter("scoring.dispatches").value
        took = metrics.counter("scoring.stream_kernel_dispatches").value
        assert dispatches == 3
        assert took == len(recorder.calls) - warm_calls
        assert took == (dispatches if on == "card" else 0)
        s.close()

    run(main())
