"""K3, the TFT forward's pointwise work as CUDA kernels (`ops/tft_fused.py`),
on the CPU. The forward is one stage code over an op table: through `OPS`
(whose ops run their plain versions off the card, through their `vmap`
rules under `vmap`) it is held bit for bit against the same code through
`PLAIN`, "the chain", stage by stage and whole, at `TftConfig`'s defaults
and at the electricity widths, with and without `vmap` over a tenant
stack with an empty slot; and on windows all valid, against the
benchmark's plain reference (`swxbench/reference/tft.py`) in bfloat16 and
float32. Also: each op's `vmap` rule against the op tenant by tenant; the
engagement rule, with the C entries replaced by a recorder so that
nothing launches; autograd through `PLAIN`; the wrapper's arguments
against the kernels' entry points; the rounded-weight cache across param
swaps; every launch in the profiler's event tree under the forward's
ranges; and the counter `scoring.tft_fused_dispatches` in the pool and the
session. The kernels themselves run only on the card (`chip_smoke.py`'s
`tft-fused` phase)."""

import contextlib

import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.models.tft import TftConfig, TftForecaster
from sitewhere_tpu_torch.ops import tft_fused as k3
from sitewhere_tpu_torch.parallel import TenantStack
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from swxbench.reference import tft as ref
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

ROWS = 5
CONFIGS = {
    "defaults": TftConfig(),
    "electricity": TftConfig(window=192, horizon=24, hidden=160, heads=4),
}


def _model(name: str, **over) -> TftForecaster:
    cfg = CONFIGS[name]
    if over:
        cfg = TftConfig(**{**cfg.__dict__, **over})
    return TftForecaster(cfg, device="cpu")


def _windows(cfg: TftConfig, rng, rows: int = ROWS):
    """Readings around 20 with a spike, and validity with gaps: a short
    history, a missing stretch, one row with none at all."""
    x = torch.from_numpy(rng.normal(20.0, 3.0, (rows, cfg.window))
                         .astype(np.float32))
    x[1, -3] += 12.0
    valid = torch.ones((rows, cfg.window), dtype=torch.bool)
    valid[0, :cfg.context // 2] = False
    valid[2, 3:9] = False
    valid[rows - 1] = False
    return x, valid


def _params(model, seed: int) -> dict:
    """`model.init`'s weights with every bias and norm drawn at random too
    (init leaves them 0 and 1, which would hide the order of additions)."""
    gen = torch.Generator().manual_seed(seed + 1000)

    def draw(node):
        if isinstance(node, dict):
            return {k: (torch.randn(v.shape, generator=gen) * 0.5
                        if k in ("b", "scale", "bias") else draw(v))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [draw(v) for v in node]
        return node

    return draw(model.init(torch.Generator().manual_seed(seed)))


def _same(got, want) -> None:
    got = got if isinstance(got, (list, tuple)) else [got]
    want = want if isinstance(want, (list, tuple)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g, w)


# -- the forward through OPS against PLAIN and the reference, by stage -------


def _stages(model, ops, params, x, valid):
    """Each stage's outputs through the op table `ops`, and the score with
    `k3.table` answering `ops`."""
    kind = k3.ROUNDINGS[model.cfg.compute_dtype]
    xn, _, _ = model._normalize(x, valid)
    r = k3.rounded_weights(ops, params, kind)
    static, past, fut = model._select(ops, r, xn, valid, kind)
    seq = model._seq2seq(ops, r, past, fut, kind)
    quant, attn = model._attend(ops, r, seq, static[1], valid, kind)
    table = k3.table
    k3.table = lambda params, x, cdt: ops
    try:
        score = model.score(params, x, valid)
    finally:
        k3.table = table
    return {"select": [*static, *past, *fut], "seq2seq": list(seq),
            "attend": [quant, attn], "whole": [score]}


def _reference(model, params, x):
    """The reference's stages on windows `x`, all valid, laid out as
    `_stages`'s float32 outputs (its attention gives no weights)."""
    cfg = model.cfg
    widths = {"window": cfg.window, "horizon": cfg.horizon,
              "hidden": cfg.hidden, "heads": cfg.heads,
              "quantiles": list(cfg.quantiles)}
    m = ref._Weights(params, cfg.compute_dtype)
    c_s, past, known = ref.selection(m, widths, ref.normalise(widths, x))
    seq = ref.sequence(m, past, known)
    return {"select": [c_s, past, known], "seq2seq": [seq],
            "attend": [ref.attention(m, widths, seq, c_s)],
            "whole": [ref.window_scores(params, widths, x,
                                        cfg.compute_dtype)]}


def _float32_of(stages: dict) -> dict:
    """`_stages`'s outputs that the reference has: the float32 values."""
    return {"select": stages["select"][::2], "seq2seq": stages["seq2seq"][:1],
            "attend": stages["attend"][:1], "whole": stages["whole"]}


def _stacked(model):
    """Three tenants' params in a stack of four slots (one empty: init
    params), and windows a slot: the third tenant's and the empty slot's
    with no valid reading."""
    rng = np.random.default_rng(7)
    stack = TenantStack(model, seed=1, device="cpu")
    for i, tid in enumerate("abc"):
        stack.add_tenant(tid, _params(model, 10 + i))
    assert stack.capacity == 4
    xs, vs = zip(*(_windows(model.cfg, rng) for _ in range(stack.capacity)))
    x, valid = torch.stack(xs), torch.stack(vs)
    valid[2:] = False
    x[3] = 0.0
    return stack.stacked, x, valid


_computed: dict = {}
REFERENCE_DTYPES = (torch.bfloat16, torch.float32)


def _both(config: str, vmapped: bool):
    """(stages through OPS, through PLAIN, and per reference dtype on
    windows all valid (through OPS, the reference's)), computed once a
    module run."""
    key = (config, vmapped)
    if key in _computed:
        return _computed[key]
    model = _model(config)
    if vmapped:
        params, x, valid = _stacked(model)
    else:
        params = _params(model, 3)
        x, valid = _windows(model.cfg, np.random.default_rng(4))

    def through(model, ops, params, x, valid):
        fn = lambda p, a, v: _stages(model, ops, p, a, v)  # noqa: E731
        return torch.func.vmap(fn)(params, x, valid) if vmapped else fn(
            params, x, valid)

    fused = through(model, k3.OPS, params, x, valid)
    plain = through(model, k3.PLAIN, params, x, valid)
    against = {}
    all_valid = torch.ones_like(valid)
    for dtype in REFERENCE_DTYPES:
        m = _model(config, compute_dtype=dtype)
        ops = k3.OPS if dtype in k3.KINDS else k3.PLAIN   # the card's table
        got = _float32_of(through(m, ops, params, x, all_valid))
        if vmapped:       # the reference, tenant by tenant
            each = [_reference(m, tree_map(lambda t: t[i], params), x[i])
                    for i in range(x.shape[0])]
            want = {s: [torch.stack([e[s][i] for e in each])
                        for i in range(len(each[0][s]))] for s in each[0]}
        else:
            want = _reference(m, params, x)
        against[dtype] = (got, want)
    _computed[key] = (fused, plain, against)
    return _computed[key]


@pytest.mark.parametrize("stage", ["select", "seq2seq", "attend", "whole"])
@pytest.mark.parametrize("vmapped", [False, True], ids=["one", "vmap"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_fused_stage_equals_chain(config, vmapped, stage):
    """The one stage code through `OPS` equals it through `PLAIN`, both
    outputs of each pair. On the CPU `OPS` runs the plain versions through
    the custom ops, so this pair checks the ops' dispatch and `vmap` rules;
    the independent checks are the reference's, here (on windows all
    valid, in bfloat16 through `OPS` and float32 through `PLAIN`), and
    JAX's in `test_torch_forecasters.py`."""
    fused, plain, against = _both(config, vmapped)
    _same(fused[stage], plain[stage])
    for dtype in REFERENCE_DTYPES:
        got, want = against[dtype]
        _same(got[stage], want[stage])


@pytest.mark.parametrize("dtype", [torch.float16], ids=["float16"])
def test_fused_forward_equals_chain_in_float16(dtype):
    """In float16 too, the forward through `OPS` equals it through
    `PLAIN` (the ops' dispatch and `vmap` rules), and on windows all valid
    the reference's (the independent check)."""
    model = _model("defaults", compute_dtype=dtype)
    params = _params(model, 5)
    x, valid = _windows(model.cfg, np.random.default_rng(6))
    for v in (valid, torch.ones_like(valid)):
        fused = _stages(model, k3.OPS, params, x, v)
        _same(fused["whole"], _stages(model, k3.PLAIN, params, x, v)["whole"])
    _same(_float32_of(fused)["attend"], _reference(model, params, x)["attend"])
    _same(fused["whole"], _reference(model, params, x)["whole"])


def test_plain_table_differentiates_every_weight_in_bfloat16(card):
    """A bf16 `loss.backward()` on the card's path, params requiring grad,
    runs `PLAIN` (no launch) and leaves a gradient on every leaf the
    forward reads: no custom op, which autograd cannot go through, is
    left in the plain table."""
    model = _model("defaults")
    params = tree_map(lambda p: p.requires_grad_(True), _params(model, 8))
    x, valid = _windows(model.cfg, np.random.default_rng(9))
    assert k3.table(params, x, model.cfg.compute_dtype) is k3.PLAIN
    model.loss(params, x, valid).backward()
    assert card.calls == []
    for t in torch.utils._pytree.tree_leaves(params):
        assert t.grad is not None and torch.isfinite(t.grad).all()
        assert t.grad.abs().sum() > 0


# -- each op's vmap rule against the op tenant by tenant ---------------------


def _op_cases(gen):
    """name → (args, which of them carry the tenant axis: True batched,
    False shared by the tenants)."""
    t = lambda *shape: torch.randn(shape, generator=gen)  # noqa: E731
    T, B, S, d = 2, 3, 4, 8
    mus = [t(T, B, S, 1) for _ in range(2)]
    variances = [t(T, B, S, 1).abs() for _ in range(2)]
    return {
        "round": ((t(T, B, S, d), 0), (True, None)),
        "dense": ((t(T, B, S, d), t(T, d), t(T, B, 1, d), t(T, d), True,
                   k3.BOTH, 0), (True, True, True, True, None, None, None)),
        "gate": ((t(T, B, S, 2 * d), t(T, 2 * d), t(B, S, d), None, 0),
                 (True, True, False, None, None)),
        "sqdev": ((t(T, B, S, d), t(T, B, S, 1), 0), (True, True, None)),
        "ln": ((t(T, B, S, d), mus[0], variances[0], t(T, d), t(T, d),
                k3.ROUNDED, 0), (True,) * 5 + (None, None)),
        "vsn": (([t(T, B, S, d), t(T, B, S, d)], mus, variances,
                 [t(T, d), t(T, d)], [t(T, d), t(T, d)], t(T, B, S, 2), 0),
                ([True, True], [True, True], [True, True], [True, True],
                 [True, True], True, None)),
        "lstm": ((t(T, B, 5, 4 * d), t(T, d, 4 * d), t(T, 4 * d), None,
                  t(B, d), 0), (True, True, True, None, False, None)),
        "embed": ((t(B, S, 2), [t(T, 1, d), t(T, 1, d)], [t(T, d), t(T, d)],
                   0), (False, [True, True], [True, True], None)),
        "logits": ((t(T, B, 2, 3, 6), torch.rand(T, B, 1, 1, 6) > 0.3, 2,
                    1.5, 0), (True, True, None, None, None)),
    }


def _tenant(args, batched, i):
    def one(a, b):
        if isinstance(a, list):
            return [one(x, y) for x, y in zip(a, b)]
        return a[i] if b else a
    return [one(a, b) for a, b in zip(args, batched)]


@pytest.mark.parametrize("name", sorted(k3.KERNELS))
def test_op_vmap_rule_equals_each_tenant(name):
    args, batched = _op_cases(torch.Generator().manual_seed(9))[name]

    def dims(b):
        if isinstance(b, list):
            return [dims(x) for x in b]
        return 0 if b else None

    got = torch.func.vmap(getattr(k3.OPS, name),
                          in_dims=tuple(dims(b) for b in batched))(*args)
    for i in range(2):
        want = getattr(k3.PLAIN, name)(*_tenant(args, batched, i))
        _same([g[i] for g in got], want)


# -- the engagement rule and the wrapper's arguments, through a recorder ------


class Recorder:
    """Stands in for the C entries: records each call (entry, operand
    descriptors, dims, scalar, kind) and launches nothing."""

    def __init__(self):
        self.calls = []

    def entry(self, name):
        def call(desc, nops, dims, f, kind, stream):
            self.calls.append({
                "name": name, "nops": nops,
                "desc": [list(desc[5 * i:5 * i + 5]) for i in range(nops)],
                "dims": list(dims[:7]), "f": f, "kind": kind})
            return 0
        return call


@pytest.fixture
def recorder(monkeypatch):
    rec = Recorder()
    monkeypatch.setattr(k3, "_c_entry", rec.entry)
    return rec


@pytest.fixture
def card(monkeypatch, recorder):
    """CPU tensors taken for the card's: `on_card` answers yes, and the
    launch's device context and stream are stand-ins."""
    monkeypatch.setattr(k3, "on_card", lambda device: True)
    monkeypatch.setattr(k3, "_stream", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return recorder


ENGAGE = {
    "cpu": ({}, False, False),
    "card": ({}, False, True),
    "card, params require grad": ({}, True, False),
    "card, float32 products": ({"compute_dtype": torch.float32}, False,
                               False),
}


@pytest.mark.parametrize("case", sorted(ENGAGE))
def test_engagement_rule(request, recorder, case):
    over, grad, fused = ENGAGE[case]
    if case != "cpu":
        request.getfixturevalue("card")
    model = _model("electricity", **over)
    params = model.init(torch.Generator().manual_seed(2))
    if grad:
        params = tree_map(lambda p: p.requires_grad_(True), params)
    x, valid = _windows(model.cfg, np.random.default_rng(3))
    assert k3.table(params, x, model.cfg.compute_dtype) is (
        k3.OPS if fused else k3.PLAIN)
    before = k3.launches
    if grad:
        loss = model.loss(params, x, valid)   # autograd through PLAIN
        loss.backward()
        assert params["head"]["w"].grad is not None
    else:
        model.score(params, x, valid)
    assert k3.launches - before == len(recorder.calls)
    if not fused:
        assert recorder.calls == []
        return
    names = [c["name"] for c in recorder.calls]
    # one cell launch a step of both LSTMs; two selections, one attention
    assert names.count("cell") == model.cfg.window
    assert names.count("embed") == names.count("vsn") == 2
    assert names.count("logits") == 1
    assert len(names) == 264
    assert {c["kind"] for c in recorder.calls} == {0}


@pytest.mark.parametrize("vmapped", [False, True], ids=["one", "vmap"])
def test_each_launch_sits_under_a_stage_range_in_the_profile(card, vmapped):
    """Every kernel launch is a `tft_fused.launch` record that the
    profiler's event tree keeps, inside the stage range around it: a reader
    of the device trace links each kernel to the record it was launched
    under (its id) and walks up to the `tft.` range. Under `vmap` the
    dispatcher records each op twice, nested, and the tree drops the inner
    record, under which a launch from the op's body would sit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model = _model("defaults")
    if vmapped:
        params, x, valid = _stacked(model)
        forward = torch.func.vmap(model.score)
    else:
        params = _params(model, 3)
        x, valid = _windows(model.cfg, np.random.default_rng(4))
        forward = model.score
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        forward(params, x, valid)
    kept = {e.id: e for e in prof.events()
            if e.device_type == DeviceType.CPU}
    raw = [k for k in prof.profiler.kineto_results.events()
           if k.name() == k3.LAUNCH_RANGE]
    assert len(raw) == len(card.calls) > model.cfg.window
    stages = []
    for k in raw:
        e = kept.get(k.correlation_id())
        assert e is not None and e.name == k3.LAUNCH_RANGE
        while e is not None and not e.name.startswith("tft."):
            e = e.cpu_parent
        assert e is not None
        stages.append(e.name)
    cells = [s for s, c in zip(stages, card.calls) if c["name"] == "cell"]
    assert cells == ["tft.seq2seq"] * model.cfg.window
    assert set(stages) == {"tft.select", "tft.seq2seq", "tft.attend"}


def _addr(t):
    return 0 if t is None else t.data_ptr()


def _desc(t, strides):
    return [_addr(t), *strides]


def test_wrapper_dense_arguments(card):
    mm = torch.randn(3, 4, 8)
    b, ctx, cb = torch.randn(8), torch.randn(3, 1, 8), torch.randn(8)
    raw, rd = k3.dense(mm, b, ctx, cb, True, k3.BOTH, 1)
    (call,) = card.calls
    assert call["name"] == "dense" and call["nops"] == 6
    assert call["dims"] == [1, 3, 4, 8, 1, 0, 4] and call["kind"] == 1
    assert call["desc"] == [
        _desc(raw, [0, 32, 8, 1]), _desc(rd, [0, 32, 8, 1]),
        _desc(mm, [0, 32, 8, 1]), _desc(b, [0, 0, 0, 1]),
        _desc(ctx, [0, 8, 0, 1]), _desc(cb, [0, 0, 0, 1])]
    assert raw.shape == rd.shape == mm.shape


def test_wrapper_gate_arguments(card):
    mm, b = torch.randn(6, 10), torch.randn(10)
    skip = torch.randn(6, 9)[:, 2:7]      # a strided skip
    (out,) = k3.gate(mm, b, skip, None, 0)
    (call,) = card.calls
    assert call["name"] == "gate" and call["dims"] == [1, 1, 6, 5, 0, 0, 1]
    assert call["desc"] == [_desc(out, [0, 0, 5, 1]),
                            _desc(mm, [0, 0, 10, 1]), _desc(b, [0, 0, 0, 1]),
                            _desc(skip, [0, 0, 9, 1]), [0, 0, 0, 0, 0]]
    assert out.shape == (6, 5)


def test_wrapper_norm_arguments(card):
    x = torch.randn(2, 3, 8)
    mu, var = torch.randn(2, 3, 1), torch.rand(2, 3, 1)
    scale, bias = torch.randn(8), torch.randn(8)
    (sq,) = k3.sqdev(x, mu, 0)
    (y,) = k3.ln(x, mu, var, scale, bias, k3.RAW, 0)
    first, second = card.calls
    assert first["name"] == "sqdev" and first["dims"] == [1, 1, 6, 8, 0, 0, 4]
    assert first["desc"] == [_desc(sq, [0, 0, 8, 1]), _desc(x, [0, 0, 8, 1]),
                             _desc(mu, [0, 0, 1, 0])]
    assert second["name"] == "ln" and second["nops"] == 7
    assert second["desc"] == [
        _desc(y, [0, 0, 8, 1]), [0, 0, 0, 0, 0], _desc(x, [0, 0, 8, 1]),
        _desc(mu, [0, 0, 1, 0]), _desc(var, [0, 0, 1, 0]),
        _desc(scale, [0, 0, 0, 1]), _desc(bias, [0, 0, 0, 1])]


def test_wrapper_vsn_arguments(card):
    xs = [torch.randn(4, 8) for _ in range(3)]
    mus = [torch.randn(4, 1) for _ in range(3)]
    var = [torch.rand(4, 1) for _ in range(3)]
    scales = [torch.randn(8) for _ in range(3)]
    biases = [torch.randn(8) for _ in range(3)]
    w = torch.rand(4, 3)
    raw, rd = k3.vsn(xs, mus, var, scales, biases, w, 0)
    (call,) = card.calls
    assert call["name"] == "vsn" and call["nops"] == 3 + 5 * 3
    assert call["dims"] == [1, 1, 4, 8, 3, 0, 4]
    want = [_desc(raw, [0, 0, 8, 1]), _desc(rd, [0, 0, 8, 1]),
            _desc(w, [0, 0, 3, 1])]
    for i in range(3):
        want += [_desc(xs[i], [0, 0, 8, 1]), _desc(mus[i], [0, 0, 1, 0]),
                 _desc(var[i], [0, 0, 1, 0]), _desc(scales[i], [0, 0, 0, 1]),
                 _desc(biases[i], [0, 0, 0, 1])]
    assert call["desc"] == want
    with pytest.raises(ValueError, match="selection inputs"):
        k3.vsn(xs * 2, mus * 2, var * 2, scales * 2, biases * 2,
               torch.rand(4, 6), 0)


@pytest.mark.parametrize("start", ["zero state", "given state"])
def test_wrapper_lstm_arguments(card, start):
    """A cell launch a step, each with that step's input product, the
    previous step's outputs and the step's slot of the sequence."""
    B, T, d = 3, 4, 8
    xw = torch.randn(B, T, 4 * d)
    wh, b = torch.randn(d, 4 * d), torch.randn(4 * d)
    h0, c0 = ((None, None) if start == "zero state"
              else (torch.randn(B, d), torch.randn(B, d)))
    before = k3.launches
    hs, h, c = k3.lstm(xw, wh, b, h0, c0, 0)
    assert k3.launches - before == T == len(card.calls)
    assert hs.shape == (B, T, d) and h.shape == c.shape == (B, d)
    prev_c = None
    for t, call in enumerate(card.calls):
        assert call["name"] == "cell" and call["nops"] == 7
        assert call["dims"] == [1, 1, B, d, 0, 0, 4]
        c_out, h_out, x_t, mm, bias, c_in, slot = call["desc"]
        assert x_t == [xw.data_ptr() + 4 * t * 4 * d, 0, 0, T * 4 * d, 1]
        assert slot == [hs.data_ptr() + 4 * t * d, 0, 0, T * d, 1]
        assert bias == [b.data_ptr(), 0, 0, 0, 1]
        assert c_out[1:] == h_out[1:] == c_in[1:] == [0, 0, d, 1]
        assert mm[1:] == [0, 0, 4 * d, 1]
        if prev_c is not None:
            assert c_in[0] == prev_c
        prev_c = c_out[0]
    assert card.calls[-1]["desc"][0][0] == c.data_ptr()
    assert card.calls[-1]["desc"][1][0] == h.data_ptr()


def test_wrapper_embed_arguments(card):
    f = torch.randn(2, 6, 3)[:, :4]       # the context's strided slice
    ws = [torch.randn(1, 8) for _ in range(3)]
    bs = [torch.randn(8) for _ in range(3)]
    raw, flat, *each = k3.embed(f, ws, bs, 0)
    (call,) = card.calls
    assert call["name"] == "embed" and call["nops"] == 5 + 3
    assert call["dims"] == [1, 2, 4, 24, 8, 3, 4]
    assert call["desc"][0] == _desc(raw, [0, 96, 24, 1])
    assert call["desc"][1] == _desc(flat, [0, 96, 24, 1])
    assert call["desc"][2] == _desc(f, [0, 18, 3, 1])
    assert call["desc"][3][1:] == [0, 0, 0, 1]    # the weights, concatenated
    assert [d for d in call["desc"][5:]] == [_desc(e, [0, 32, 8, 1])
                                             for e in each]
    assert raw.shape == (2, 4, 3, 8) and flat.shape == (2, 4, 24)


def test_wrapper_logits_and_round_arguments(card):
    e = torch.randn(3, 2, 4, 9)
    valid = torch.rand(3, 1, 1, 9) > 0.5
    (out,) = k3.logits(e, valid, 5, 2.0, 0)
    (r,) = k3.round_(e.transpose(1, 2), 0)
    first, second = card.calls
    assert first["name"] == "logits" and first["dims"] == [1, 3, 8, 9, 4, 5, 1]
    assert first["f"] == pytest.approx(0.5)
    assert first["desc"] == [_desc(out, [0, 72, 9, 1]),
                             _desc(e, [0, 72, 9, 1]),
                             _desc(valid, [0, 9, 0, 1])]
    # a dense transposed input keeps its layout: its 216 elements in memory
    # order, as rows of 8 (the largest power of two to 32 dividing them)
    assert second["name"] == "round" and second["dims"] == [1, 1, 27, 8, 0, 0, 4]
    assert r.stride() == e.transpose(1, 2).stride()


PLANS = {
    "bias over rows": ([(2, 3, 4), (4,)], (1, 1, 6), [(0, 0, 4, 1),
                                                    (0, 0, 0, 1)]),
    "context row over steps": ([(2, 3, 4), (2, 1, 4)], (1, 2, 3),
                               [(0, 12, 4, 1), (0, 4, 0, 1)]),
    "per-row scalar": ([(2, 3, 4), (2, 3, 1)], (1, 1, 6),
                       [(0, 0, 4, 1), (0, 0, 1, 0)]),
    "tenant axis": ([(5, 2, 3, 4), (5, 1, 1, 4)], (1, 5, 6),
                    [(0, 24, 4, 1), (0, 4, 0, 1)]),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_broadcasts_and_merges_rows(case):
    shapes, dims, strides = PLANS[case]
    got = k3._plan([torch.zeros(s) for s in shapes])
    assert got == (dims, strides)


def test_plan_refuses_four_row_dims():
    a = torch.zeros(2, 3, 4, 5, 6)
    b = torch.zeros(2, 1, 4, 1, 6)
    with pytest.raises(ValueError, match="row dimensions"):
        k3._plan([a, b])


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_no_launch_off_the_card(recorder, where):
    x = torch.zeros(2, 4, device=where)
    before = k3.launches
    with pytest.raises(ValueError, match="on the card"):
        k3._launch("sqdev", [x, x, torch.zeros(2, 1, device=where)], 4, 0)
    assert recorder.calls == [] and k3.launches == before


def test_launch_refuses_mixed_devices_and_types(card):
    with pytest.raises(ValueError, match="operand on meta"):
        k3._launch("sqdev", [torch.zeros(2, 4), torch.zeros(2, 4),
                             torch.zeros(2, 1, device="meta")], 4, 0)
    with pytest.raises(ValueError, match="float32"):
        k3._launch("sqdev", [torch.zeros(2, 4), torch.zeros(2, 4),
                             torch.zeros(2, 1, dtype=torch.float64)], 4, 0)
    assert card.calls == []


# -- the rounded weights, cached a version ------------------------------------


def test_rounded_weights_are_cached_until_written():
    model = _model("defaults")
    stack = TenantStack(model, device="cpu")
    stack.add_tenant("a", model.init(torch.Generator().manual_seed(1)))
    first = k3.rounded_weights(k3.OPS, stack.stacked, 0)
    again = k3.rounded_weights(k3.OPS, stack.stacked, 0)
    assert again["grn_static"]["fc1"]["w"] is first["grn_static"]["fc1"]["w"]
    assert again["static"] is stack.stacked["static"]   # not a weight
    stack.set_params("a", model.init(torch.Generator().manual_seed(2)))
    after = k3.rounded_weights(k3.OPS, stack.stacked, 0)
    w = after["grn_static"]["fc1"]["w"]
    assert w is not first["grn_static"]["fc1"]["w"]
    assert torch.equal(w, stack.stacked["grn_static"]["fc1"]["w"]
                       .to(torch.bfloat16).float())


def _store(n: int, seed: int, tid: str, window: int) -> tuple:
    store = TelemetryStore(history=window + 8, initial_devices=n)
    sim = DeviceSimulator(SimConfig(num_devices=n, seed=seed), tenant_id=tid)
    for k in range(window + 4):
        store.append_measurements(sim.tick(t=60.0 * k)[0])
    return store, sim


DEVICES = 24


def _plain_scores(model, params, store, dev):
    x, valid = store.window(dev, model.cfg.window)
    return model.score(params, torch.from_numpy(x),
                       torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("path", ["pool", "session"])
def test_swapped_params_score_through_k3(monkeypatch, run, path):
    """The forward through `OPS` (its plain versions, on the CPU) serves a
    tenant, its params are swapped, and the next scores are `PLAIN`'s with
    the new params: the rounded-weight cache follows the swap."""
    model = _model("defaults")
    monkeypatch.setattr(k3, "engaged",
                        lambda params, x, cdt: cdt in k3.KINDS)
    old, new = _params(model, 1), _params(model, 2)

    async def main():
        store, sim = _store(DEVICES, 50, "a", model.cfg.window)
        delivered = []

        async def deliver(scored):
            delivered.append(scored)

        if path == "pool":
            pool = SharedScoringPool(
                model, MetricsRegistry(),
                PoolConfig(batch_buckets=(32,), batch_window_ms=1.0,
                           readback="full", score_dtype="float32"),
                device="cpu")
            slot = pool.register("a", store, 4.0, deliver, params=old)
            await wait_until(lambda: pool.ready, timeout=30.0)
        else:
            sink = ScoringSession(model, store, MetricsRegistry(),
                                  ScoringConfig(buckets=(32,), threshold=4.0,
                                                readback="full",
                                                score_dtype="float32"),
                                  params=old, device="cpu")
            sink.warmup()
        scores = []
        for params in (old, new):
            if params is new:
                (slot if path == "pool" else sink).swap_params(new)
            batch, _ = sim.tick(t=6000.0 + 60.0 * len(scores))
            if path == "pool":
                slot.admit(batch)
                pool.flush_nowait()
                await wait_until(lambda: len(delivered) > len(scores),
                                 timeout=10.0)
                got = delivered[-1]
            else:
                sink.admit(batch)
                got = await sink.flush()
            store.append_measurements(batch)
            order = np.argsort(got.device_index)
            want = _plain_scores(model, params, store,
                                 got.device_index[order])
            np.testing.assert_array_equal(got.score[order], want)
            scores.append(got.score[order])
        assert not np.array_equal(scores[0], scores[1])
        if path == "pool":
            pool.close()
        else:
            sink.close()

    run(main())


# -- the counter -----------------------------------------------------------------


def _counted_pool(model_name: str, on_card: bool, run, **cfg):
    model = (build_model(model_name, device="cpu", **cfg))

    async def main():
        metrics = MetricsRegistry()
        pool = SharedScoringPool(
            model, metrics, PoolConfig(batch_buckets=(32,),
                                       batch_window_ms=1.0), device="cpu")
        delivered = []

        async def deliver(scored):
            delivered.append(scored)

        window = getattr(model.cfg, "window", 16)
        store, sim = _store(DEVICES, 60, "a", window)
        pool.register("a", store, 4.0, deliver)
        await wait_until(lambda: pool.ready, timeout=30.0)
        launches0 = k3.launches
        for k in range(2):
            pool.admit("a", sim.tick(t=6000.0 + 60.0 * k)[0])
            pool.flush_nowait()
            await wait_until(lambda k=k: len(delivered) >= k + 1,
                             timeout=10.0)
        dispatches = metrics.counter("scoring.dispatches").value
        took = metrics.counter("scoring.tft_fused_dispatches").value
        pool.close()
        return dispatches, took, k3.launches - launches0

    return run(main())


@pytest.mark.parametrize("on", ["card", "cpu"])
def test_pool_counts_k3_dispatches(request, run, recorder, on):
    if on == "card":
        request.getfixturevalue("card")
    dispatches, took, launched = _counted_pool("tft", on == "card", run,
                                               window=24, horizon=4,
                                               hidden=8, heads=2,
                                               min_history=8)
    assert dispatches >= 2
    if on == "card":
        assert took == dispatches and launched > 0
    else:
        assert took == 0 and launched == 0


def test_stream_pool_counts_no_k3_dispatch(run, card):
    dispatches, took, launched = _counted_pool("lstm-stream", True, run,
                                               window=16, hidden=16)
    assert dispatches >= 2 and took == 0 and launched == 0


@pytest.mark.parametrize("on", ["card", "cpu"])
def test_session_counts_k3_dispatches(request, run, recorder, on):
    if on == "card":
        request.getfixturevalue("card")
    model = build_model("tft", device="cpu", window=24, horizon=4, hidden=8,
                        heads=2, min_history=8)

    async def main():
        store, sim = _store(DEVICES, 70, "t", 24)
        metrics = MetricsRegistry()
        s = ScoringSession(model, store, metrics,
                           ScoringConfig(buckets=(32,), threshold=4.0),
                           device="cpu")
        s.warmup()
        for k in range(2):
            s.admit(sim.tick(t=6000.0 + 60.0 * k)[0])
            await s.flush()
        dispatches = metrics.counter("scoring.dispatches").value
        took = metrics.counter("scoring.tft_fused_dispatches").value
        s.close()
        return dispatches, took

    dispatches, took = run(main())
    assert dispatches == 2
    assert took == (dispatches if on == "card" else 0)

