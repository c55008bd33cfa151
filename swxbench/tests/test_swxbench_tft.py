"""`correct` comes out false in the `tft-flood` cell when the TFT's
forward is broken underneath, and the cell's score limit sits below the
float8 control.

Each fault test drives the rest of a run on the CPU at a small size
(`small.small_cell`: 512 devices, buckets of 64 and 256, the published
widths kept) with one fault planted in the program's model, and sees the
score check fail:

- the decoder LSTM's outputs replaced by zeros (the horizon's recurrence
  lost);
- the attention's context dropped (every head's output zero).

And the control: the plain reference with its products in float8, put in
the program's place, fails the score limit.
"""

from __future__ import annotations

import pytest
import torch

from swxbench.control import control_gap
from swxbench.tests.small import run_small, small_cell

CELL = "tft-flood"


def _decoder_zeroed(monkeypatch):
    from sitewhere_tpu_torch.models import tft

    scan = tft.lstm_scan

    def zeroed(params, seq, cdt, h0=None, c0=None):
        out, state = scan(params, seq, cdt, h0=h0, c0=c0)
        return (torch.zeros_like(out) if h0 is not None else out), state

    monkeypatch.setattr(tft, "lstm_scan", zeroed)


def _context_dropped(monkeypatch):
    from sitewhere_tpu_torch.models import tft

    einsum = tft._einsum_round

    def dropped(eq, a, b, cdt):
        out = einsum(eq, a, b, cdt)
        return torch.zeros_like(out) if eq == "bnqk,bkd->bnqd" else out

    monkeypatch.setattr(tft, "_einsum_round", dropped)


FAULTS = {"decoder_zeroed": _decoder_zeroed,
          "context_dropped": _context_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = run_small(CELL, seconds=0.6)
    assert out["correct"] is False
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert failed == {"score_gap"}, out["checks"]


def test_the_sound_run_is_correct():
    out = run_small(CELL, seconds=0.6)
    assert out["correct"] is True, out["checks"]


def test_the_float8_control_fails_the_score_limit():
    cell = small_cell(CELL)
    got = control_gap(cell, seed=2**31 + 5, messages=96, device="cpu")
    assert got["control"] == "float8_e4m3fn"
    assert got["score_gap"] > got["limit"], got


# -- the cell's files and its readers --------------------------------------------

def test_the_cell_finds_its_files_by_name():
    from swxbench import spec

    cell = spec.cell(CELL)
    ref = cell.reference()
    assert ref.scores and ref.make_params and ref.counts
    assert cell.traffic == {"kind": "flood", "gateways": 16, "tick_s": 60.0,
                            "anomaly_rate": 0.001, "anomaly_magnitude": 12.0,
                            "warmup_messages": 64}
    assert cell.config["widths"]["window"] == 192
    names = {m.name for m in cell.per_layer}
    host = ("decode_ms", "enrich_ms", "persist_ms", "publish_ms",
            "settle_host_ms", "gc_share", "idle_in_gc", "idle_in_dispatch",
            "idle_in_persist")
    assert names == {"tft_roofline.tft", "tft_seq2seq_share.tft", "mfu.tft",
                     "device_idle.tft", "dispatch_host_ms.tft",
                     "events_per_dispatch.tft",
                     *(f"{h}.tft" for h in host)}
    assert [m.name for m in cell.end_to_end] == ["events_per_s", "setup_s"]
    for metric in cell.end_to_end + cell.per_layer:
        module = __import__(f"swxbench.readers.{metric.reader}",
                            fromlist=["read"])
        assert callable(module.read)


class _Range:
    def __init__(self, a, b):
        self.start, self.end = a, b


class _Event:
    """What the readers use of a profiler event (µs from the trace's
    start), and of its raw twin (ns since the epoch)."""
    ids = iter(range(1, 10**6))
    T0_NS = 1_700_000_000_000_000_000

    def __init__(self, name, a, b, cuda=False, parent=None, link=0):
        from torch.autograd import DeviceType

        self.id = next(self.ids)
        self.name = name
        self.time_range = _Range(a, b)
        self.device_type = DeviceType.CUDA if cuda else DeviceType.CPU
        self.cpu_parent = parent
        self.link = link
        self.is_user_annotation = False

    # the raw result's accessors
    def linked_correlation_id(self):
        return self.link

    def start_ns(self):
        return self.T0_NS + int(self.time_range.start * 1e3)

    def duration_ns(self):
        return int((self.time_range.end - self.time_range.start) * 1e3)


class _Raw:
    def __init__(self, events):
        self._events = events

    def trace_start_ns(self):
        return _Event.T0_NS

    def events(self):
        return [_RawEvent(e) for e in self._events]


class _RawEvent:
    def __init__(self, e):
        self.e = e

    def __getattr__(self, name):
        return getattr(self.e, name)

    def device_type(self):
        return self.e.device_type

    def is_user_annotation(self):
        return self.e.is_user_annotation


class _Prof:
    def __init__(self, events):
        self._events = events
        self.profiler = type("P", (), {"kineto_results": _Raw(events)})()

    def events(self):
        return self._events


class _Stretch:
    def __init__(self, prof, events, dispatches):
        self.prof = prof
        self._delta = {"events": events, "dispatches": dispatches}

    def delta(self, name):
        return self._delta[name]


def _trace(forwards, lo=100.0, hi=1100.0):
    """A stretch [lo, hi] µs and, one a forward, its three stages'
    kernels as (launch time, [(stage, device start, device end)])."""
    from swxbench.trace import MARK

    events = [_Event(MARK, lo, hi)]
    for t, kernels in forwards:
        ranges = {}
        for stage, a, b in kernels:
            if stage not in ranges:
                ranges[stage] = _Event(stage, t + len(ranges),
                                       t + len(ranges) + 0.9)
                events.append(ranges[stage])
            op = _Event("aten::mm", ranges[stage].time_range.start,
                        ranges[stage].time_range.start + 0.1,
                        parent=ranges[stage])
            events += [op, _Event("gemm", a, b, cuda=True, link=op.id)]
    # a kernel outside every range: not the model's
    copy = _Event("aten::copy_", lo + 1, lo + 2)
    events += [copy, _Event("memcpy", lo + 5, lo + 15, cuda=True,
                            link=copy.id)]
    return events


def _view(events, rows_per_dispatch, dispatches=4):
    from swxbench.readers import range_share
    from swxbench.run import RunView

    range_share._walked[:] = [None, None]
    st = _Stretch(_Prof(events), rows_per_dispatch * dispatches, dispatches)
    return RunView(None, None, st, None, 0.0, {
        "window": 192, "horizon": 24, "hidden": 160, "heads": 4,
        "quantiles": [0.1, 0.5, 0.9]}, 0.0, True)


def test_the_readers_attribute_kernels_to_the_stages():
    from swxbench.readers import range_device_share, tft_roofline
    from swxbench.reference.tft import counts
    from swxbench.roofline import bound_s

    # forward 1 whole inside; forward 2 half outside the stretch's end; a
    # leading forward that began before the profiler (no tft.select)
    events = _trace([
        (50.0, [("tft.seq2seq", 100.0, 160.0), ("tft.attend", 160.0, 200.0)]),
        (120.0, [("tft.select", 200.0, 300.0), ("tft.seq2seq", 300.0, 500.0),
                 ("tft.attend", 500.0, 600.0)]),
        (400.0, [("tft.select", 900.0, 1000.0),
                 ("tft.seq2seq", 1000.0, 1200.0),
                 ("tft.attend", 1200.0, 1300.0)]),
    ])
    view = _view(events, rows_per_dispatch=16384)
    share = range_device_share.read(view, stage="tft.seq2seq", prefix="tft.")
    # inside the stretch, seq2seq 60 + 200 + 100 µs of the stages'
    # 100 + 400 + 200 (the memcpy under no range is no stage's)
    assert share == pytest.approx(100.0 * 360.0 / 700.0)
    # forwards 2 and 3: 1 + 0.5 of a forward's rows over 400 + 200 µs
    flops, nbytes = counts(view.widths, 1.5 * 16384)
    want = 100.0 * bound_s(flops, nbytes) / 600e-6
    assert tft_roofline.read(view) == pytest.approx(want)


def test_the_readers_find_nothing_without_the_ranges():
    from swxbench.readers import range_device_share, tft_roofline

    # the parent program: dispatches with no tft ranges
    events = _trace([])
    view = _view(events, rows_per_dispatch=16384)
    assert tft_roofline.read(view) is None
    assert range_device_share.read(view, stage="tft.seq2seq",
                                   prefix="tft.") is None
    # a run off the card, or untraced
    view.on_card = False
    assert tft_roofline.read(view) is None
    view.stretch = None
    assert range_device_share.read(view, stage="tft.seq2seq",
                                   prefix="tft.") is None
