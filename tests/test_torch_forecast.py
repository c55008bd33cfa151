"""The port's predictive control plane (`sitewhere_tpu_torch/fleet/
forecast.py`) held to the JAX package's on the cases of
`tests/test_forecast.py`.

The same telemetry history is written into a `TelemetryHistory` of each
package (the same appends, the same clock), and:

- `FeaturePipeline` gives equal series, feature tensors and training
  windows in both packages, gaps and all (restart holes masked, the open
  live tail readable, flush-split rows merged, the grid's since/until
  bounds, history replayed across a restart);
- the reserved tenant-0 stays out of the lag roster, fair admission and
  tenant CRUD in the port as in the reference;
- `PredictivePlanner` demotes a cold model, a stale forecast and a high
  horizon error with the same gate reasons and counts in both; it trains
  from history and serves tenant-0 through the port's pool on the CPU to
  a forecast-attributed `add_replica`; and with the JAX planner's trained
  `seasonal` weights swapped into the port's, both serve the same
  forecasts (float32 model: within 1e-3 relative, 1e-2 absolute) and
  take the same decision on a frozen wall clock.

Every wait has its own deadline.
"""

import asyncio
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sitewhere_tpu import config as jconfig
from sitewhere_tpu.fleet import controller as jcontroller
from sitewhere_tpu.fleet import forecast as jforecast
from sitewhere_tpu.kernel import metrics as jmetrics
from sitewhere_tpu.persistence import durable as jdurable
from sitewhere_tpu_torch import config as tconfig
from sitewhere_tpu_torch.config import RESERVED_TENANT
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.fleet import controller as tcontroller
from sitewhere_tpu_torch.fleet import forecast as tforecast
from sitewhere_tpu_torch.kernel import metrics as tmetrics
from sitewhere_tpu_torch.kernel.observe import per_tenant_lags
from sitewhere_tpu_torch.persistence import durable as tdurable

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

WS = 1.0
FORECAST_ATOL, FORECAST_RTOL = 1e-2, 1e-3

JAX = SimpleNamespace(config=jconfig, controller=jcontroller,
                      forecast=jforecast, metrics=jmetrics,
                      durable=jdurable, settings={})
PORT = SimpleNamespace(config=tconfig, controller=tcontroller,
                       forecast=tforecast, metrics=tmetrics,
                       durable=tdurable, settings={"device": "cpu"})
PKGS = {"jax": JAX, "port": PORT}


def histories(tmp_path, name="hist"):
    """One `TelemetryHistory` a package, each over its own directory."""
    return {k: pkg.durable.TelemetryHistory(str(tmp_path / k / name),
                                            window_s=WS)
            for k, pkg in PKGS.items()}


def fill_ramp(hs, tenant, t0, n, *, slope=100.0, gap=()):
    """n windows of a lag ramp into every history, skipping the window
    indices in `gap` (a worker restart: the beat wrote nothing)."""
    for h in hs.values():
        for i in range(n):
            if i in gap:
                continue
            h.append(tenant, "lag", slope * i, t=t0 + i * WS + 0.25)
            h.append(tenant, "lag", slope * i, t=t0 + i * WS + 0.75)


def each(hs, fn):
    """`fn(pkg, history)` for both packages; asserts equal numpy
    outputs and returns the port's."""
    out = {k: fn(PKGS[k], h) for k, h in hs.items()}
    for a, b in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return out["port"]


def flush(hs):
    for h in hs.values():
        h.flush()


def close(hs):
    for h in hs.values():
        h.close()


# -- the feature pipeline ------------------------------------------------------


def test_restart_gap_windows_are_invalid_not_zero(tmp_path):
    hs = histories(tmp_path)
    t0 = math.floor(time.time() / WS) * WS - 40 * WS
    fill_ramp(hs, "acme", t0, 20, gap=(7, 8))
    flush(hs)
    vals, valid, starts = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).load_series("acme", window=20, until=t0 + 20 * WS))
    assert starts[0] == t0
    assert not valid[7] and not valid[8]
    assert valid[6] and valid[9]
    assert vals[9] == pytest.approx(900.0)
    w, wv = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).training_windows(["acme"], 12, until=t0 + 20 * WS))
    assert w.shape[0] > 0 and (~wv).any()
    close(hs)


def test_open_live_tail_window_is_readable(tmp_path):
    hs = histories(tmp_path)
    open_w = math.floor(time.time() / WS) * WS
    t0 = open_w - 5 * WS
    fill_ramp(hs, "acme", t0, 5)
    for h in hs.values():
        h.append("acme", "lag", 999.0, t=open_w + 0.1)
    vals, valid, starts = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).load_series("acme", window=6, until=open_w + WS))
    assert starts[-1] == open_w
    assert valid[-1] and vals[-1] == pytest.approx(999.0)
    _, _, starts2 = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).load_series("acme", window=5, until=open_w))
    assert starts2[-1] == open_w - WS
    close(hs)


def test_flush_split_rows_merge_to_one_window_mean(tmp_path):
    hs = histories(tmp_path)
    w0 = math.floor(time.time() / WS) * WS - 10 * WS
    for h in hs.values():
        h.append("acme", "lag", 100.0, t=w0 + 0.2)
        h.flush()  # closes the open window: the next append splits it
        h.append("acme", "lag", 300.0, t=w0 + 0.8)
        h.flush()
    vals, valid, _ = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).load_series("acme", window=1, until=w0 + WS))
    assert valid[0] and vals[0] == pytest.approx(200.0)
    close(hs)


def test_since_until_boundary_semantics_on_grid(tmp_path):
    hs = histories(tmp_path)
    w0 = math.floor(time.time() / WS) * WS - 20 * WS
    fill_ramp(hs, "acme", w0, 10)
    flush(hs)
    vals, valid, starts = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).load_series("acme", window=5, until=w0 + 5 * WS))
    assert starts[0] == w0 and starts[-1] == w0 + 4 * WS
    assert valid.all() and vals[-1] == pytest.approx(400.0)
    x, v, _ = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).features(["acme"], window=10, until=w0 + 10 * WS))
    assert x.shape == (1, 10, len(tforecast.SIGNALS))
    assert v[0, :, tforecast.SIGNALS.index("lag")].all()
    close(hs)


def test_features_and_windows_equal_on_a_mixed_history(tmp_path):
    """Every signal of the feature axis, three tenants with gaps of
    their own and a fleet-wide loop lag: equal tensors in both."""
    hs = histories(tmp_path)
    w0 = math.floor(time.time() / WS) * WS - 50 * WS
    rng = np.random.default_rng(7)
    points = []
    for tid, gap in (("acme", (3, 4)), ("beta", (10,)), ("gamma", ())):
        for i in range(40):
            if i in gap:
                continue
            for sig in tforecast.SIGNALS:
                owner = "w0" if sig == "loop_lag_ms" else tid
                for frac in (0.1, 0.6):
                    points.append((owner, sig, float(rng.gamma(2.0, 50.0)),
                                   w0 + i * WS + frac))
    for h in hs.values():
        for owner, sig, v, t in points:
            h.append(owner, sig, v, t=t)
        h.flush()
    x, v, _ = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).features(["acme", "beta", "gamma"], window=40,
                    until=w0 + 40 * WS))
    assert x.shape == (3, 40, len(tforecast.SIGNALS)) and not v.all()
    w, wv = each(hs, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).training_windows(["acme", "beta", "gamma"], 16,
                            until=w0 + 40 * WS))
    assert w.shape[0] > 0 and w.shape[1] == 16
    close(hs)


def test_restart_survival_feeds_feature_builder(tmp_path):
    t0 = math.floor(time.time() / WS) * WS - 30 * WS
    hs = histories(tmp_path, "h")
    fill_ramp(hs, "acme", t0, 10)
    close(hs)  # process death; closed rows are on disk
    hs2 = {k: PKGS[k].durable.TelemetryHistory(str(tmp_path / k / "h"),
                                               window_s=WS) for k in PKGS}
    fill_ramp(hs2, "acme", t0 + 14 * WS, 6, slope=50.0)
    flush(hs2)
    _, valid, _ = each(hs2, lambda pkg, h: pkg.forecast.FeaturePipeline(
        h).load_series("acme", window=20, until=t0 + 20 * WS))
    assert valid[:10].all() and not valid[10:14].any() and valid[14:].all()
    close(hs2)


# -- the reserved tenant-0 -------------------------------------------------------


def test_per_tenant_lags_drops_reserved_tenant():
    lags = {"acme.inbound": {"t": 5}, f"{RESERVED_TENANT}.inbound": {"t": 50},
            "fleet.controller": {"t": 9}}
    assert per_tenant_lags(lags) == {"acme": 5}


def test_admit_fair_bypasses_reserved_tenant(run):
    from sitewhere_tpu_torch.kernel.flow import FlowController

    flow = FlowController(settings=tconfig.InstanceSettings(
        flow_inbound_rate=1.0), metrics=tmetrics.MetricsRegistry())

    async def main():
        t0 = time.monotonic()
        for _ in range(20):
            await flow.admit_fair(RESERVED_TENANT, cost=5.0)
        assert time.monotonic() - t0 < 0.5

    run(main())


def test_add_tenant_rejects_reserved_id(run):
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime

    async def main():
        runtime = ServiceRuntime(tconfig.InstanceSettings(
            instance_id="test", observe_enabled=False))
        await runtime.start()
        try:
            with pytest.raises(ValueError, match="reserved"):
                await runtime.add_tenant(
                    tconfig.TenantConfig(tenant_id=RESERVED_TENANT))
        finally:
            await runtime.stop()

    run(main())


# -- the planner -------------------------------------------------------------------


def make_controller(pkg, data_dir, history, **policy_kw):
    settings = pkg.config.InstanceSettings(
        data_dir=str(data_dir), fleet_forecast_window=16,
        fleet_forecast_horizon_s=4.0, fleet_forecast_interval_s=0.0,
        fleet_forecast_min_windows=6, fleet_forecast_max_stale_s=30.0,
        **pkg.settings)
    runtime = SimpleNamespace(settings=settings,
                              metrics=pkg.metrics.MetricsRegistry(),
                              history=history, tracer=None, faults=None)
    policy = pkg.controller.AutoscalerPolicy(**{
        "scale_up_lag": 300.0, "cooldown_s": 0.0, **policy_kw})
    return SimpleNamespace(runtime=runtime, policy=policy,
                           tenants={"acme": object(), "beta": object()},
                           _last_scale_t=-1e9, _pending_spawns=0)


def planners(tmp_path, hs):
    return {k: PKGS[k].forecast.PredictivePlanner(make_controller(
        PKGS[k], tmp_path / k / "data", h)) for k, h in hs.items()}


def test_the_port_serves_on_the_named_device(tmp_path):
    hs = histories(tmp_path)
    planner = planners(tmp_path, hs)["port"]
    assert planner.device == torch.device("cpu")
    assert planner.model.device == torch.device("cpu")
    close(hs)


def test_cold_start_demotes_to_reactive_in_both(tmp_path):
    hs = histories(tmp_path)
    t0 = math.floor(time.time() / WS) * WS - 30 * WS
    fill_ramp(hs, "acme", t0, 20)
    flush(hs)
    for planner in planners(tmp_path, hs).values():
        assert planner.decide({"w1": 0.0}, {}) is None
        assert planner.decide({"w1": 0.0}, {}) is None
        assert planner.demotions_c.value == 1
        assert "not started" in planner.snapshot()["gate"]
    close(hs)


def _served(planner, *, age_s: float, load: float = 1e6):
    planner._trained = True
    planner.pool = object()  # serving "up" for the gate's purposes
    planner.slot = object()
    planner.forecasts["acme"] = {
        "load": load, "made_t": time.time() - age_s,
        "made_monotonic": time.monotonic() - age_s, "model_version": 1}


def test_stale_forecast_regates_in_both(tmp_path):
    hs = histories(tmp_path)
    t0 = math.floor(time.time() / WS) * WS - 30 * WS
    fill_ramp(hs, "acme", t0, 28)
    flush(hs)
    out = {}
    for k, planner in planners(tmp_path, hs).items():
        _served(planner, age_s=100.0)
        stale = planner.decide({"w1": 0.0}, {})
        gate = planner.snapshot()["gate"]
        planner.forecasts["acme"]["made_monotonic"] = time.monotonic()
        fresh = planner.decide({"w1": 0.0}, {})
        out[k] = (stale, gate, fresh["action"], fresh["reason"],
                  fresh["forecast"]["tenants"], planner.demotions_c.value)
    assert out["port"] == out["jax"]
    assert out["port"][0] is None and "no fresh forecast" in out["port"][1]
    assert out["port"][2] == "add_replica"
    close(hs)


def test_high_horizon_error_demotes_in_both(tmp_path):
    hs = histories(tmp_path)
    t0 = math.floor(time.time() / WS) * WS - 30 * WS
    fill_ramp(hs, "acme", t0, 28)
    flush(hs)
    out = {}
    for k, planner in planners(tmp_path, hs).items():
        _served(planner, age_s=0.0)
        planner.error_ema = planner.error_gate * 2
        out[k] = (planner.decide({"w1": 0.0}, {}),
                  planner.snapshot()["gate"], planner.demotions_c.value)
    assert out["port"] == out["jax"]
    assert "horizon error" in out["port"][1] and out["port"][2] == 1
    close(hs)


async def _serve_until_forecasts(planner, hs, t0, *, timeout=30.0):
    """Tick the planner until every tenant has a forecast, keeping the
    ramp alive so newly closed windows keep arriving."""
    await planner.tick()  # starts serving, backfills, registers
    deadline = time.monotonic() + timeout
    while set(planner.forecasts) != {"acme", "beta"}:
        assert time.monotonic() < deadline, planner.snapshot()
        wall = time.time()
        i = (wall - t0) / WS
        for h in hs:
            for tid in ("acme", "beta"):
                h.append(tid, "lag", 40.0 * i, t=wall)
        await planner.tick()
        await asyncio.sleep(0.1)


def test_trains_from_history_and_emits_forecast_decision(run, tmp_path):
    """Ramp history → the port's trainer → tenant-0 slot in the port's
    pool on the CPU → one forecast-attributed add_replica, its
    provenance recorded."""
    hs = histories(tmp_path)
    now_w = math.floor(time.time() / WS) * WS
    t0 = now_w - 60 * WS
    for tid in ("acme", "beta"):
        fill_ramp(hs, tid, t0, 58, slope=40.0)
    flush(hs)
    planner = planners(tmp_path, hs)["port"]
    report = planner.train_from_history(steps=25)
    assert report is not None and report["version"] == 1
    assert planner.trainings_c.value == 1

    async def main():
        await _serve_until_forecasts(planner, [hs["port"]], t0)
        return planner.decide({"w1": 1.0}, {})

    try:
        decision = run(main())
        assert decision is not None, planner.snapshot()
        assert decision["action"] == "add_replica"
        assert decision["reason"].startswith("forecast:")
        prov = decision["forecast"]
        assert prov["horizon_s"] == pytest.approx(4.0)
        assert prov["predicted_load"] > 0
        assert planner.snapshot()["model_version"] == 1
        assert planner.decisions_c.value == 1
        assert RESERVED_TENANT in planner.pool.tenants
        assert planner.pool.device == torch.device("cpu")
        assert planner.snapshot()["gate"] == "ok"
        # the checkpoint went through the port's npz store
        params, meta = planner._checkpoint_store().load(RESERVED_TENANT,
                                                        "seasonal")
        assert meta["version"] == 1 and meta["windows"] == report["windows"]
    finally:
        planner.close()
        close(hs)


def test_same_weights_same_forecasts_and_decision(run, tmp_path,
                                                  monkeypatch):
    """The JAX planner trains from the history; its `seasonal` weights
    go into the port's planner through `convert` (the layout of
    `model.init`). On a wall clock frozen at two points (serving starts
    and backfills six windows before the history's end, then four more
    windows close) both planners admit the same closed windows through
    their pools and serve the same forecasts and the same decision."""
    import jax

    hs = histories(tmp_path)
    now_w = math.floor(time.time() / WS) * WS
    t0 = now_w - 60 * WS
    for tid in ("acme", "beta"):
        fill_ramp(hs, tid, t0, 58, slope=40.0)
    flush(hs)
    ps = planners(tmp_path, hs)
    clock = [now_w - 6 * WS + 0.5]
    report = ps["jax"].train_from_history(steps=25, until=now_w)
    assert report is not None
    weights = jax.tree_util.tree_map(np.asarray,
                                     ps["jax"]._pending_params)
    ps["port"]._pending_params = params_from_numpy(weights, "cpu")
    ps["port"]._trained = True
    ps["port"].model_version = ps["jax"].model_version
    monkeypatch.setattr(time, "time", lambda: clock[0])

    async def main():
        for p in ps.values():
            await p.tick()  # serving starts: backfill, register
        clock[0] += 4 * WS
        deadline = time.monotonic() + 30.0
        while any(set(p.forecasts) != {"acme", "beta"}
                  for p in ps.values()):
            assert time.monotonic() < deadline, {
                k: p.snapshot() for k, p in ps.items()}
            for p in ps.values():
                await p.tick()  # admits the closed windows once
            await asyncio.sleep(0.05)
        return {k: p.decide({"w1": 1.0}, {}) for k, p in ps.items()}

    try:
        decisions = run(main())
        got = {k: {t: f["load"] for t, f in p.forecasts.items()}
               for k, p in ps.items()}
        for tid, load in got["jax"].items():
            assert got["port"][tid] == pytest.approx(
                load, rel=FORECAST_RTOL, abs=FORECAST_ATOL), got
        d_port, d_jax = decisions["port"], decisions["jax"]
        assert d_jax is not None and d_port is not None
        assert d_port["action"] == d_jax["action"] == "add_replica"
        assert d_port["forecast"]["model_version"] \
            == d_jax["forecast"]["model_version"]
        assert d_port["forecast"]["tenants"] == pytest.approx(
            d_jax["forecast"]["tenants"], rel=FORECAST_RTOL,
            abs=FORECAST_ATOL)
    finally:
        for p in ps.values():
            p.close()
        close(hs)
