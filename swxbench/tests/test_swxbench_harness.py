"""The harness's own pieces on the CPU: the names it finds, the traffic it
draws, the reference it holds the program to, the counts it divides by,
and the line it prints.

    python -m pytest swxbench/tests -q
"""

from __future__ import annotations

import asyncio
import math
import sys
import time

import numpy as np
import pytest
import torch

from swxbench import generator, roofline, spec
from swxbench.generator import TrafficPlan
from swxbench.reference import lstm_stream, lstm_window
from swxbench.reference.lstm_cell import Cell
from swxbench.run import forbidden_modules
from swxbench.tests.small import run_small
from swxbench.window import RunRecord, _send

CELLS = ("stream-flood",)


# -- names ---------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_files_by_name(name):
    cell = spec.cell(name)
    assert cell.reference().scores
    assert cell.traffic["kind"] in ("flood", "gateway")
    assert "score_gap" in cell.limits
    for metric in cell.end_to_end + cell.per_layer:
        module = __import__(f"swxbench.readers.{metric.reader}",
                            fromlist=["read"])
        assert callable(module.read)
    assert "setup_s" in [m.name for m in cell.end_to_end]


def test_every_benchmark_name_has_its_file():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (spec.PKG / "metrics" / f"{m['name']}.json").exists()
    for c in bench["configs"]:
        assert (spec.ROOT / c["file"]).exists()


def test_unknown_names_are_refused(tmp_path):
    with pytest.raises(spec.SpecError):
        spec.cell("no-such-cell")
    bench = spec.benchmark()
    bench["workloads"][0]["traffic"] = "no-such-mix"
    with pytest.raises(spec.SpecError):
        spec.cell(bench["workloads"][0]["name"], bench)
    with pytest.raises(spec.SpecError):
        spec._safe("../etc", "traffic")
    with pytest.raises(ValueError):
        TrafficPlan({"kind": "burst"}, 64, 0, 1)


# -- traffic -------------------------------------------------------------------

def _plan(seed: int, **kw) -> TrafficPlan:
    params = {"kind": "gateway", "gateways": 16, "rate_events_per_s": 5120,
              "anomaly_rate": 0.01, "anomaly_magnitude": 12.0, **kw}
    return TrafficPlan(params, 512, 68, seed)


def test_traffic_is_deterministic_from_the_seed():
    big = 2**31 + 12345
    a, b, c = _plan(big), _plan(big), _plan(big + 1)
    assert np.array_equal(a.warm, b.warm)
    for i in (0, 5, 16, 40):
        assert a.payload(i) == b.payload(i)
    assert not np.array_equal(a.warm, c.warm)
    assert a.payload(3) != c.payload(3)


def test_gateway_slices_cover_the_fleet_once_a_period():
    plan = _plan(3)
    # each message's device ids, read back from its SWB1 payload
    devs = np.concatenate([
        np.frombuffer(plan.payload(i), np.uint32, plan.slice, 10)
        for i in range(16)])
    assert np.array_equal(np.sort(devs), np.arange(512))
    assert math.isclose(plan.interval_s * 16, plan.period_s)
    assert math.isclose(plan.period_s, 512 / 5120)
    ts = np.array([plan.ts(i) for i in range(64)])
    assert np.array_equal(plan.message_of_ts(ts), np.arange(64))
    assert plan.message_of_ts(np.array([plan.t0 + 1.0]))[0] == -1
    # a message's readings are drawn at its own time stamp
    k, g = plan.split(21)
    lo = g * plan.slice
    assert np.all(np.diff(ts[:16]) == plan.tick_s / 16)
    assert plan.tick_values(k)[lo:lo + plan.slice].shape == (plan.slice,)


class _Receiver:
    """Takes every message, or rejects each `reject_every`-th offer."""

    def __init__(self, reject_every: int = 0):
        self.offers = 0
        self.taken = []
        self.reject_every = reject_every

    async def submit(self, payload):
        self.offers += 1
        await asyncio.sleep(0)
        if self.reject_every and self.offers % self.reject_every == 0:
            return False
        self.taken.append(payload)
        return True


class _Dep:
    def __init__(self, receiver):
        self.receiver = receiver


def test_gateway_sends_each_message_at_its_due_time():
    plan = _plan(4, rate_events_per_s=32 * 16 * 40)   # 640 messages/s
    record = RunRecord(plan=plan)

    async def go():
        start = time.monotonic()
        await _send(_Dep(_Receiver()), plan, record, 0, None, start,
                    start + 0.25)
        return start

    start = asyncio.run(go())
    due = np.asarray(record.due)
    assert len(due) == math.ceil(0.25 / plan.interval_s)
    assert np.allclose(np.diff(due), plan.interval_s)
    assert due[0] == start
    late = np.asarray(record.taken) - due
    assert late.min() >= 0


def test_flood_offers_a_rejected_message_again_and_cycles_its_ticks(
        monkeypatch):
    monkeypatch.setattr(generator, "FLOOD_TICKS", 4)
    plan = TrafficPlan({"kind": "flood", "gateways": 1, "tick_s": 60.0},
                       64, 2, 2**31 + 11)
    plan.prefill(1.0)
    assert len(plan.ticks) == 4
    receiver = _Receiver(reject_every=3)
    record = RunRecord(plan=plan)
    asyncio.run(_send(_Dep(receiver), plan, record, 0, 10,
                      time.monotonic(), None))
    # every message taken once, in order, each rejection offered again
    assert record.accepted == [True] * 10
    assert record.rejections == receiver.offers - 10 > 0
    assert receiver.taken == [plan.payload(i) for i in range(10)]
    # tick k sends tick k mod 4's readings at its own time stamp
    assert np.array_equal(plan.tick_values(6), plan.tick_values(2))
    assert plan.ts(6) - plan.ts(2) == 4 * plan.tick_s
    assert len(plan.ticks) == 4


# -- the reference -------------------------------------------------------------

def _zero_params(h: int, head_b: float) -> dict:
    z = torch.zeros
    return {"lstm0": {"wx": z(1, 4 * h), "wh": z(h, 4 * h), "b": z(4 * h)},
            "head": {"w": z(h, 1), "b": torch.tensor([head_b])}}


def test_windowed_reference_against_a_hand_worked_window():
    # zero weights: every gate is 0, g = tanh(0) = 0, so c and h stay 0 and
    # the prediction is the head's bias; the score is |bias − newest z|
    w = 8
    x = torch.arange(1.0, 9.0)[None, :]
    mean, var = 4.5, 5.25
    z_last = (8.0 - mean) / math.sqrt(var + 1e-6)
    got = lstm_window.scores(_zero_params(4, 0.5), {"window": w, "hidden": 4},
                             x, w - 1, torch.bfloat16)
    assert got.shape == (1, 1)
    # the window is the last 8 readings, the newest one last
    want = abs(0.5 - z_last)
    assert math.isclose(float(got[0, 0]), want, rel_tol=1e-6)


def test_streaming_reference_against_hand_worked_steps():
    w = 8
    warm = [float(i) for i in range(1, 9)]
    sent = [12.0, 3.0]
    values = torch.tensor([warm + sent])
    got = lstm_stream.scores(_zero_params(4, 0.5), {"window": w, "hidden": 4},
                             values, w, torch.bfloat16)[0]
    mean, var, count = 4.5, 5.25, w
    want = []
    for v in sent:
        z = (v - mean) / math.sqrt(var + 1e-6)
        want.append(min(abs(z - 0.5), 50.0))
        count = min(count + 1, w)
        delta = v - mean
        mean += delta / count
        var += ((v - mean) * delta - var) / count
    assert np.allclose(got.numpy(), want, rtol=1e-5)


def test_one_cell_step_by_hand():
    params = {"lstm0": {"wx": torch.tensor([[0.5, -1.0, 2.0, 0.25]]),
                        "wh": torch.tensor([[1.0, 0.5, -0.5, 2.0]]),
                        "b": torch.tensor([0.0, 1.0, 0.0, 0.0])},
              "head": {"w": torch.tensor([[3.0]]), "b": torch.tensor([0.5])}}
    cell = Cell(params, torch.float32)
    h, c = cell.step(torch.tensor([2.0]), torch.tensor([[0.5]]),
                     torch.tensor([[1.0]]))
    sig = lambda t: 1 / (1 + math.exp(-t))
    gi, gf, gg, go = 2 * 0.5 + 0.5, 2 * -1.0 + 0.25 + 1, 2 * 2 - 0.25, 0.5 + 1
    c1 = sig(gf) * 1.0 + sig(gi) * math.tanh(gg)
    h1 = sig(go) * math.tanh(c1)
    assert math.isclose(float(c[0, 0]), c1, rel_tol=1e-6)
    assert math.isclose(float(h[0, 0]), h1, rel_tol=1e-6)
    assert math.isclose(float(cell.head(h)[0]), 3 * h1 + 0.5, rel_tol=1e-6)


def test_products_round_through_the_stated_dtype():
    params = lstm_window.make_params({"hidden": 8}, 1, "cpu")
    x = torch.randn(4, 16)
    ref = lstm_window.window_scores(Cell(params, torch.bfloat16), x)
    low = lstm_window.window_scores(Cell(params, torch.float8_e4m3fn), x)
    exact = lstm_window.window_scores(Cell(params, torch.float32), x)
    assert not torch.equal(ref, exact) and not torch.equal(low, ref)


# -- counts --------------------------------------------------------------------

def test_flop_counts_from_the_widths():
    widths = {"window": 64, "hidden": 64}
    assert lstm_stream.flops_per_event(widths) == 33_408
    assert lstm_window.flops_per_event(widths) == 2_096_768


def test_k1_bound_for_a_fleet_tick_half():
    flops, nbytes = roofline.k1_counts(16384, 63, 64, 1)
    assert flops == 2.0 * 16384 * 63 * 65 * 256
    assert nbytes == 16384 * 63 * 4 + 16384 * 64 * 4 + (512 + 32768 + 1024)
    # operations bound it: 34.7 µs at 989 TFLOP/s
    assert math.isclose(roofline.bound_s(flops, nbytes), flops / 989e12)
    assert 34.6e-6 < roofline.bound_s(flops, nbytes) < 34.8e-6


def test_the_jax_check_compares_whole_top_level_names(monkeypatch):
    for name in ("sitewhere_tpu_torch.x", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, object())
    assert forbidden_modules() == []
    for name in ("sitewhere_tpu.kernel", "jaxlib", "flax.core", "jax"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name.split(".")[0] in forbidden_modules()


# -- a run ---------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_a_run_prints_the_contract_keys_with_checks_last(name):
    out = run_small(name)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    e2e = {m.name for m in spec.cell(name).end_to_end}
    assert set(out["metrics"]) == e2e
    for check in out["checks"].values():
        assert check["value"] <= check["limit"]


def test_a_traced_run_reports_its_per_layer_metrics():
    out = run_small("stream-flood", trace=True)
    assert out["correct"] is True
    assert {"decode_ms.flood", "persist_ms.flood", "enrich_ms.flood",
            "events_per_dispatch.flood"} <= set(out["metrics"])
    # no device here: nothing reads a device share off the CPU
    for name in ("device_idle.flood", "mfu.flood"):
        assert name not in out["metrics"]
    assert "breakdown" in out


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import json
    import subprocess

    out = subprocess.run(
        [sys.executable, "-m", "swxbench", "--workload", "stream-flood",
         "--seed", str(2**31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600,
        check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
