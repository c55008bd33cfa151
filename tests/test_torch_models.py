"""The port's models (sitewhere_tpu_torch/models/) held against the JAX
package's on identical inputs and identical weights.

Inputs are numpy arrays from a seed; JAX weights cross to the port via
`convert.params_from_numpy`. Tolerances:

- scan path (`lstm_scan`, `score`, `forecast`): both sides feed bf16
  operands, but the port rounds each matmul output to bf16 as the
  reference writes it (`models/common.py:51-52`) while XLA on the CPU
  keeps that product in f32. The hidden states then differ by bf16
  noise (≈4e-3 measured); atol 1e-2 on h, 3e-2 on scores (normalized
  units, the JAX package's own kernel-vs-scan bound).
- kernel path (`score_fused`): the port's plain kernel version vs the
  Pallas kernel in interpret mode, same operands and f32 accumulation,
  atol 2e-3 on scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.models import build_model as jax_build
from sitewhere_tpu.models.common import lstm_init, lstm_scan
from sitewhere_tpu.ops.lstm_kernel import lstm_window_final as jax_window_final
from sitewhere_tpu_torch.convert import params_from_numpy, params_to_numpy
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.models.common import lstm_scan as torch_lstm_scan


def _np_params(jax_model, seed):
    return jax.tree.map(np.asarray, jax_model.init(jax.random.PRNGKey(seed)))


def _windows(seed, batch, window, short_rows=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((batch, window)) * 3.0 + 20.0).astype(np.float32)
    valid = np.ones((batch, window), bool)
    valid[:short_rows, : window - 4] = False  # 4-point history < gate 8
    return x, valid


def _pair(name, seed, **cfg):
    jm = jax_build(name, **cfg)
    tm = build_model(name, device="cpu", **cfg)
    p = _np_params(jm, seed)
    return jm, tm, p, params_from_numpy(p, "cpu")


@pytest.mark.parametrize("d_in", [1, 16])
def test_lstm_scan_matches_jax(d_in):
    p = jax.tree.map(np.asarray, lstm_init(jax.random.PRNGKey(d_in), d_in, 16))
    seq = np.random.default_rng(d_in).standard_normal((24, 20, d_in)).astype(np.float32)
    hs_j, (h_j, c_j) = lstm_scan(p, jnp.asarray(seq).astype(jnp.bfloat16),
                                 jnp.bfloat16)
    hs_t, (h_t, c_t) = torch_lstm_scan(params_from_numpy(p, "cpu"),
                                       torch.from_numpy(seq).bfloat16(),
                                       torch.bfloat16)
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs_j), atol=1e-2)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-2)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-2)


def test_lstm_scan_float32_matches_jax_tightly():
    """With an f32 compute dtype there is no bf16 rounding on either
    side: the scans agree to float32 summation noise (atol 1e-5)."""
    p = jax.tree.map(np.asarray, lstm_init(jax.random.PRNGKey(9), 1, 16))
    seq = np.random.default_rng(9).standard_normal((8, 12, 1)).astype(np.float32)
    hs_j, _ = lstm_scan(p, jnp.asarray(seq), jnp.float32)
    hs_t, _ = torch_lstm_scan(params_from_numpy(p, "cpu"),
                              torch.from_numpy(seq), torch.float32)
    np.testing.assert_allclose(hs_t.numpy(), np.asarray(hs_j), atol=1e-5)


@pytest.mark.parametrize("layers", [1, 2])
def test_lstm_score_matches_jax(layers):
    jm, tm, p, tp = _pair("lstm", layers, window=32, hidden=32, layers=layers)
    x, valid = _windows(layers, 64, 32, short_rows=8)
    want = np.asarray(jm.score(p, jnp.asarray(x), jnp.asarray(valid)))
    got = tm.score(tp, torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=3e-2)
    # the short-history gate is exact on both sides
    assert (got[:8] == 0).all() and (want[:8] == 0).all()


def test_lstm_forecast_matches_jax():
    """Forecasts are in original units (sd ≈ 3): atol 3e-2 · 3."""
    jm, tm, p, tp = _pair("lstm", 11, window=32, hidden=32)
    x, valid = _windows(11, 48, 32)
    want = np.asarray(jm.forecast(p, jnp.asarray(x), jnp.asarray(valid)))
    got = tm.forecast(tp, torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    assert got.shape == want.shape == (48, 1, 1)
    np.testing.assert_allclose(got, want, atol=9e-2)


def test_score_fused_matches_jax_kernel_path_interpret():
    """The port's score_fused on the CPU (plain kernel version) vs the JAX
    kernel path in interpret mode, built as tests/test_pallas.py builds
    it; atol 2e-3 in normalized units."""
    jm, tm, p, tp = _pair("lstm", 5, window=32)
    x, valid = _windows(5, 256, 32, short_rows=64)
    xj, vj = jnp.asarray(x), jnp.asarray(valid)
    xn, _, _ = jm._normalize(xj, vj.astype(jnp.float32))
    h = jax_window_final(p["lstm0"], xn[:, :-1], jm.cfg.compute_dtype,
                         use_pallas=True, interpret=True)
    pred = (h @ p["head"]["w"] + p["head"]["b"])[:, 0]
    want = np.asarray(jm._finalize(pred, xn, vj))
    got = tm.score_fused(tp, torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)
    assert (got[:64] == 0).all()


def test_score_fused_is_score_for_configs_without_kernel():
    """A two-layer or f32 model is another configuration: score_fused is
    exactly score there (decided by config, never by a failure)."""
    for cfg in ({"layers": 2}, {"compute_dtype": torch.float32}):
        tm = build_model("lstm", device="cpu", window=16, hidden=16, **cfg)
        assert not tm.fused
        tp = tm.init(torch.Generator().manual_seed(0))
        x, valid = _windows(0, 16, 16)
        xt, vt = torch.from_numpy(x), torch.from_numpy(valid)
        assert torch.equal(tm.score_fused(tp, xt, vt), tm.score(tp, xt, vt))


def test_zscore_matches_jax():
    """Pure float32 elementwise math: atol 1e-5."""
    jm, tm, p, tp = _pair("zscore", 0, window=32)
    x, valid = _windows(7, 64, 32, short_rows=8)
    x[40:48, -1] += 40.0  # spikes reach the clip
    want = np.asarray(jm.score(p, jnp.asarray(x), jnp.asarray(valid)))
    got = tm.score(tp, torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[40:48].min() > 4.0


def test_init_layout_matches_jax():
    """Same tree, shapes and dtypes as the JAX init (so weights move leaf
    for leaf), with the forget-gate bias at +1."""
    jm = jax_build("lstm", window=16, hidden=8, layers=2)
    tm = build_model("lstm", device="cpu", window=16, hidden=8, layers=2)
    want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), _np_params(jm, 0))
    got = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                       params_to_numpy(tm.init(torch.Generator().manual_seed(0))))
    assert got == want
    b = tm.init()["lstm0"]["b"]
    assert (b[8:16] == 1).all() and (b[:8] == 0).all() and (b[16:] == 0).all()


def test_convert_round_trip():
    jm = jax_build("lstm", window=16, hidden=8)
    p = _np_params(jm, 3)
    back = params_to_numpy(params_from_numpy(p, "cpu"))
    jax.tree.map(np.testing.assert_array_equal, back, p)


def test_registry_and_flops():
    for name, cfg in (("lstm", {"window": 64, "hidden": 64}),
                      ("zscore", {"window": 64})):
        assert (build_model(name, device="cpu", **cfg).flops_per_event()
                == jax_build(name, **cfg).flops_per_event())
    with pytest.raises(ValueError):
        build_model("tft", device="cpu")
