"""`correct` comes out false when the timed path is broken underneath.

Each test drives the rest of a run on the CPU at a small size (the
harness's look for a card skipped) with one fault planted in the program
under the harness, and sees the check that should catch it fail:

- a step that returns its state unchanged (the streaming cell's state not
  advanced);
- half of each scored batch left out (never published);
- an answer altered where it is produced (every score a tenth too high).

The exchange between chips is not a fault these cells can have: each runs
on one chip. And the control: the plain reference with its products in
float8, put in the program's place, fails the score limit.
"""

from __future__ import annotations

import numpy as np
import pytest

from swxbench.control import control_gap
from swxbench.tests.small import run_small, small_cell

CELLS = ("stream-flood",)


def _state_unchanged(monkeypatch, name):
    from sitewhere_tpu_torch.models.lstm import StreamingLstmModel

    step = StreamingLstmModel.step_score

    def frozen(self, params, rows, v):
        score, _ = step(self, params, rows, v)
        return score, dict(rows)

    monkeypatch.setattr(StreamingLstmModel, "step_score", frozen)


def _half_left_out(monkeypatch, name):
    from sitewhere_tpu_torch.scoring import pool, server

    deliver = server.deliver_scored

    async def half(sink, scored, *args, **kw):
        keep = np.arange(len(scored)) < (len(scored) + 1) // 2
        return await deliver(sink, scored.select(keep), *args, **kw)

    monkeypatch.setattr(server, "deliver_scored", half)
    monkeypatch.setattr(pool, "deliver_scored", half)


def _answer_altered(monkeypatch, name):
    from sitewhere_tpu_torch.models.lstm import StreamingLstmModel

    step = StreamingLstmModel.step_score

    def biased(self, params, rows, v):
        score, out = step(self, params, rows, v)
        return score + 0.1, out

    monkeypatch.setattr(StreamingLstmModel, "step_score", biased)


FAULTS = {"state_unchanged": (_state_unchanged, "score_gap"),
          "half_left_out": (_half_left_out, "lost"),
          "answer_altered": (_answer_altered, "score_gap")}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(monkeypatch, name, fault):
    plant, check = FAULTS[fault]
    plant(monkeypatch, name)
    out = run_small(name, seconds=0.6)
    assert out["correct"] is False
    failed = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    assert check in failed, out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_float8_control_fails_the_score_limit(name):
    cell = small_cell(name)
    got = control_gap(cell, seed=2**31 + 5, messages=96, device="cpu")
    assert got["control"] == "float8_e4m3fn"
    assert got["score_gap"] > got["limit"], got
