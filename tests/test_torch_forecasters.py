"""The port's forecasters (`tft`, `longwin`, `seasonal`), its dense
attention and the forecast query surface held against the JAX package's
on identical inputs and identical weights (JAX params through
`convert.params_from_numpy`; the port cannot reproduce `jax.random`, so
its own `init` is held to the JAX layout, not its values).

Tolerances:
- float32 on both sides (`compute_dtype=float32`, which removes the
  bf16 rounding gap of ROADMAP C): atol 1e-4 for `tft` and `longwin`
  (forecasts in original units: 1e-4 plus 1e-6 relative); `seasonal` is
  all float32 by design, atol 1e-5 plus 1e-6 relative; gradients of each
  `loss` 1e-4 plus 1e-3 relative.
- bf16 on both sides (the default): the port rounds each product to
  bf16 where the reference casts, XLA on the CPU may keep it in float32.
  Measured over eight seeds at these sizes (max |Δ|): tft score 0.033,
  forecast 0.055 (original units, sd ≈ 3), attention 4.4e-3, loss
  2.9e-4; longwin score 3.4e-3, loss 1.5e-5. Allowed: tft score 5e-2,
  forecast 0.1, attention 1e-2, loss 1e-3; longwin score 1e-2, loss 1e-4.
- serving (the pool, a dedicated session, the stacked `vmap`): float32
  models with float32 score readback, atol 1e-4 plus 1e-4 relative
  against the JAX model's `score` on the same stored windows (an
  anomaly tick scores up to the clip, 50, and a longwin score of 6.7
  was measured 3.4e-4 off: the window's normalisation divides float32
  rounding by a small std); stacked vs per-tenant 1e-5.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu import services as jservices
from sitewhere_tpu.kernel import service as jservice
from sitewhere_tpu.models import build_model as jax_build
from sitewhere_tpu.parallel.ring import dense_attention_reference
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch import services as tservices
from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
from sitewhere_tpu_torch.kernel import service as tservice
from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.parallel import TenantStack, dense_attention
from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
from sitewhere_tpu_torch.scoring.pool import PoolConfig, SharedScoringPool
from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig
from tests.test_pipeline import wait_until

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

CFGS = {
    "tft": dict(window=32, horizon=6, hidden=16, heads=4, min_history=8),
    "longwin": dict(window=48, hidden=16, heads=4, layers=2, min_history=8),
    "seasonal": dict(window=32, horizon=6),
}
SURFACES = {"tft": ("forecast", "attention", "score", "loss"),
            "longwin": ("score", "loss"),
            "seasonal": ("forecast", "score", "loss")}
F32_CASES = [(m, s) for m, ss in SURFACES.items() for s in ss]
BF16_ATOL = {("tft", "score"): 5e-2, ("tft", "forecast"): 0.1,
             ("tft", "attention"): 1e-2, ("tft", "loss"): 1e-3,
             ("longwin", "score"): 1e-2, ("longwin", "loss"): 1e-4}


def _cfg(name: str, dtype: str) -> tuple[dict, dict]:
    """(JAX config, port config) for `name` in compute dtype `dtype`."""
    cfg = CFGS[name]
    if name == "seasonal":
        return dict(cfg), dict(cfg)
    return ({**cfg, "compute_dtype": getattr(jnp, dtype)},
            {**cfg, "compute_dtype": getattr(torch, dtype)})


def _pair(name: str, dtype: str = "float32", seed: int = 1):
    jc, tc = _cfg(name, dtype)
    jm = jax_build(name, **jc)
    tm = build_model(name, device="cpu", **tc)
    p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    if name == "seasonal":
        # zero init is the model; random corrections exercise every term
        rng = np.random.default_rng(seed)
        p = {k: (v + rng.normal(0.0, 0.1, v.shape)).astype(np.float32)
             for k, v in p.items()}
    return jm, tm, p, params_from_numpy(p, "cpu")


def _windows(window: int, seed: int = 0, batch: int = 12):
    """Rows of raw telemetry: a short-history row, a gap row, an empty
    row and full rows."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, window)) * 3.0 + 20.0).astype(np.float32)
    valid = np.ones((batch, window), bool)
    valid[0, : window - 5] = False            # under every history gate
    valid[1, window // 3: window // 2] = False  # a gap
    valid[2] = False                          # nothing at all
    return x, valid


def _call(model, surface, params, x, valid):
    out = getattr(model, surface)(params, x, valid)
    return np.asarray(out.detach() if hasattr(out, "detach") else out)


@pytest.mark.parametrize("name,surface", F32_CASES)
def test_float32_matches_jax(name, surface):
    jm, tm, p, tp = _pair(name)
    x, valid = _windows(jm.cfg.window)
    want = _call(jm, surface, p, jnp.asarray(x), jnp.asarray(valid))
    got = _call(tm, surface, tp, torch.from_numpy(x), torch.from_numpy(valid))
    assert got.shape == want.shape
    atol, rtol = (1e-5, 1e-6) if name == "seasonal" else (1e-4, 1e-6)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


@pytest.mark.parametrize("name,surface", list(BF16_ATOL))
def test_bfloat16_matches_jax(name, surface):
    jm, tm, p, tp = _pair(name, "bfloat16", seed=4)
    x, valid = _windows(jm.cfg.window, seed=4)
    want = _call(jm, surface, p, jnp.asarray(x), jnp.asarray(valid))
    got = _call(tm, surface, tp, torch.from_numpy(x), torch.from_numpy(valid))
    np.testing.assert_allclose(got, want, atol=BF16_ATOL[(name, surface)])


@pytest.mark.parametrize("name", list(CFGS))
def test_loss_gradient_matches_jax_grad(name):
    jm, tm, p, tp = _pair(name)
    x, valid = _windows(jm.cfg.window, seed=2)
    want = jax.grad(jm.loss)(p, jnp.asarray(x), jnp.asarray(valid))
    leaves, treedef = jax.tree.flatten(
        jax.tree.map(lambda t: t.requires_grad_(True), tp,
                     is_leaf=lambda t: isinstance(t, torch.Tensor)))
    tm.loss(jax.tree.unflatten(treedef, leaves), torch.from_numpy(x),
            torch.from_numpy(valid)).backward()
    # longwin's q/k/v biases are unused (as in the reference): no grad
    got = jax.tree.unflatten(treedef, [
        t.grad.numpy() if t.grad is not None
        else np.zeros(t.shape, np.float32) for t in leaves])
    jax.tree.map(lambda g, w: np.testing.assert_allclose(
        g, np.asarray(w), atol=1e-4, rtol=1e-3), got, want)


@pytest.mark.parametrize("name", list(CFGS))
def test_init_keeps_the_jax_layout(name):
    """Same tree (dict keys, list lengths), shapes and dtypes as the JAX
    `init` — the checkpoint and `convert.py` contract."""
    jm, tm, p, _ = _pair(name)
    mine = params_to_numpy(tm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(p)
    jax.tree.map(lambda a, b: (a.shape, a.dtype) == (b.shape, b.dtype)
                 or pytest.fail(f"{a.shape}/{a.dtype} vs {b.shape}/{b.dtype}"),
                 mine, p)
    assert tm.flops_per_event() == jm.flops_per_event()


@pytest.mark.parametrize("cfg", [
    dict(horizon=32), dict(hidden=30, heads=4), dict(heads=0),
    dict(quantiles=(0.5,)), dict(quantiles=(0.1, 0.1, 0.9)),
    dict(quantiles=(0.0, 0.5, 0.9)), dict(quantiles=(0.1, 0.5, 1.0))])
def test_tft_refuses_the_configs_jax_refuses(cfg):
    full = {**CFGS["tft"], **cfg}
    with pytest.raises(ValueError):
        jax_build("tft", **full)
    with pytest.raises(ValueError):
        build_model("tft", device="cpu", **full)


@pytest.mark.parametrize("dtype,causal", [("float32", True),
                                          ("float32", False),
                                          ("bfloat16", True)])
def test_dense_attention_matches_the_reference(dtype, causal):
    """The port's dense attention against `dense_attention_reference`:
    float32 atol 1e-5, bf16 inputs 1e-2 (the rounded scores). Row 0 has
    no valid key at all and row 1's first key is invalid, so the causal
    query 0 sees none: those outputs are zero in both."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((4, 16, 2, 8)).astype(np.float32)
               for _ in range(3))
    valid = np.ones((4, 16), bool)
    valid[0] = False
    valid[1, 0] = False
    valid[2, 5:9] = False
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(dense_attention_reference(
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), jnp.asarray(valid),
        causal=causal))
    got = dense_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)),
                          torch.from_numpy(valid), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 if dtype == "float32"
                               else 1e-2)
    assert not got[0].any()
    if causal:
        assert not got[1, 0].any()


# -- serving: the pool, a dedicated session, the stacked vmap ---------------

DEVICES = 24


def _store(window: int, seed: int):
    store = TelemetryStore(history=64, initial_devices=DEVICES)
    sim = DeviceSimulator(SimConfig(num_devices=DEVICES, seed=seed),
                          tenant_id="t")
    for k in range(window + 4):
        store.append_measurements(sim.tick(t=60.0 * k)[0])
    return store, sim


def _expect(jm, p, store, dev):
    x, valid = store.window(dev, jm.cfg.window)
    return np.asarray(jm.score(p, jnp.asarray(x), jnp.asarray(valid)))


@pytest.mark.parametrize("name", ["tft", "longwin"])
def test_pool_scores_like_the_jax_model(run, name):
    """Two tenants with their own weights through one pool (float32
    readback), a fleet tick and an anomaly tick: every event scored, each
    score within 1e-4 plus 1e-4 relative of the JAX model's on the
    store's windows."""

    async def main():
        jc, tc = _cfg(name, "float32")
        jm = jax_build(name, **jc)
        pool = SharedScoringPool(
            build_model(name, device="cpu", **tc), MetricsRegistry(),
            PoolConfig(batch_buckets=(32,), batch_window_ms=1.0,
                       score_dtype="float32"), device="cpu")
        tenants, got = {}, {}
        try:
            for i, tid in enumerate(("a", "b")):
                p = jax.tree.map(np.asarray,
                                 jm.init(jax.random.PRNGKey(20 + i)))
                store, sim = _store(jm.cfg.window, 30 + i)
                got[tid] = []

                async def deliver(scored, tid=tid):
                    got[tid].append(scored)

                pool.register(tid, store, 4.0, deliver,
                              params=params_from_numpy(p, "cpu"))
                tenants[tid] = (p, store, sim)
            await wait_until(lambda: pool.ready, timeout=60.0)
            for k, rate in enumerate((0.0, 0.2)):
                for tid, (p, store, sim) in tenants.items():
                    sim.cfg = SimConfig(num_devices=DEVICES, seed=sim.cfg.seed,
                                        anomaly_rate=rate,
                                        anomaly_magnitude=12.0)
                    batch = sim.tick(t=60.0 * (jm.cfg.window + 4 + k))[0]
                    store.append_measurements(batch)
                    pool.admit(tid, batch)
                pool.flush_nowait()
                await wait_until(lambda: all(
                    sum(len(b) for b in got[t]) == DEVICES * (k + 1)
                    for t in got), timeout=60.0)
                for tid, (p, store, _) in tenants.items():
                    scored = got[tid][-1]
                    np.testing.assert_allclose(
                        scored.score, _expect(jm, p, store,
                                              scored.device_index),
                        atol=1e-4, rtol=1e-4)
        finally:
            pool.close()

    run(main())


@pytest.mark.parametrize("name", ["tft", "longwin"])
def test_session_scores_like_the_jax_model(run, name):
    async def main():
        jc, tc = _cfg(name, "float32")
        jm = jax_build(name, **jc)
        p = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(5)))
        store, sim = _store(jm.cfg.window, 6)
        got = []

        async def sink(scored):
            got.append(scored)

        session = ScoringSession(
            build_model(name, device="cpu", **tc), store, MetricsRegistry(),
            ScoringConfig(buckets=(32,), batch_window_ms=1.0,
                          score_dtype="float32"),
            params=params_from_numpy(p, "cpu"), sink=sink, device="cpu")
        session.warmup()
        batch = sim.tick(t=60.0 * (jm.cfg.window + 4))[0]
        store.append_measurements(batch)
        session.admit(batch)
        await session.flush()
        await wait_until(lambda: sum(len(b) for b in got) == DEVICES,
                         timeout=60.0)
        scored = got[-1]
        np.testing.assert_allclose(
            scored.score, _expect(jm, p, store, scored.device_index),
            atol=1e-4, rtol=1e-4)
        session.close()

    run(main())


@pytest.mark.parametrize("name", list(CFGS))
def test_stacked_vmap_equals_per_tenant_scores(name):
    """`torch.func.vmap(model.score)` over three tenants' stacked params
    (the TFT's list-bearing tree included) equals each tenant scored on
    its own, within 1e-5."""
    _, tm, _, _ = _pair(name)
    stack = TenantStack(tm, device="cpu")
    params = {}
    for i in range(3):
        params[i] = tm.init(torch.Generator().manual_seed(40 + i))
        stack.add_tenant(f"t{i}", params[i])
    xs, vs = zip(*(_windows(tm.cfg.window, seed=50 + i, batch=8)
                   for i in range(stack.capacity)))
    got = stack.score(np.stack(xs), np.stack(vs)).numpy()
    for i in range(3):
        want = tm.score(params[i], torch.from_numpy(xs[i]),
                        torch.from_numpy(vs[i])).numpy()
        np.testing.assert_allclose(got[i], want, atol=1e-5)
        leaf = stack.get_params(f"t{i}")
        assert jax.tree.structure(params_to_numpy(leaf)) == \
            jax.tree.structure(params_to_numpy(params[i]))


# -- the forecast query surface ------------------------------------------------

def _forecast_runtime(pkg):
    rt = pkg.service.ServiceRuntime(pkg.config.InstanceSettings(
        instance_id="fc", **pkg.settings))
    for name in ("DeviceManagementService", "EventManagementService",
                 "RuleProcessingService"):
        rt.add_service(getattr(pkg.services, name)(rt))
    return rt


class _Pkg:
    def __init__(self, service, config, services, settings, dtype, place):
        self.service, self.config, self.services = service, config, services
        self.settings, self.dtype, self.place = settings, dtype, place


JAX = _Pkg(jservice, jconfig, jservices, {}, jnp.float32, lambda p: p)
PORT = _Pkg(tservice, tconfig, tservices, {"device": "cpu"}, torch.float32,
            lambda p: params_from_numpy(p, "cpu"))


async def _forecast(pkg, model: str, cfg: dict, params, device: int,
                    include_attention: bool):
    rt = _forecast_runtime(pkg)
    await rt.start()
    try:
        await rt.add_tenant(pkg.config.TenantConfig(
            tenant_id="t", sections={"rule-processing": {
                "model": model,
                "model_config": {**cfg, "compute_dtype": pkg.dtype},
                "buckets": [16], "score_dtype": "float32"}}))
        em = rt.api("event-management").management("t")
        sim = DeviceSimulator(SimConfig(num_devices=8, seed=9),
                              tenant_id="t")
        for k in range(cfg["window"] + 4):
            em.telemetry.append_measurements(sim.tick(t=60.0 * k)[0])
        eng = rt.api("rule-processing").engine("t")
        eng.swap_model_params(pkg.place(params))
        return await eng.forecast_device(device,
                                         include_attention=include_attention)
    finally:
        await rt.stop()


FORECASTS = {
    "lstm": (dict(window=16, hidden=8), False),
    "tft-attention": (CFGS["tft"], True),
}


@pytest.mark.parametrize("case", list(FORECASTS))
def test_forecast_device_matches_jax(run, case):
    """The same weights and stored telemetry queried through both
    packages' `forecast_device`: the same result dict — horizon,
    quantile levels, history points, and (for the TFT) the [heads, H, W]
    attention — with forecasts within 1e-4 plus 1e-6 relative (float32
    on both sides)."""
    cfg, attention = FORECASTS[case]
    model = case.split("-")[0]
    jm = jax_build(model, **cfg, compute_dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(8)))
    got = run(_forecast(PORT, model, cfg, params, 3, attention))
    want = run(_forecast(JAX, model, cfg, params, 3, attention))
    assert set(got) == set(want)
    for key in ("device_index", "horizon", "quantiles", "history_points"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["forecast"], want["forecast"], atol=1e-4,
                               rtol=1e-6)
    if attention:
        np.testing.assert_allclose(got["attention"], want["attention"],
                                   atol=1e-5)
        assert np.asarray(got["attention"]).shape == (4, 6, 32)
