"""The port's fused window kernel (sitewhere_tpu_torch/ops/lstm_kernel.py)
held against the JAX package's Pallas kernel and scan path.

On the CPU the wrapper runs the kernel's plain PyTorch version (a CPU
tensor never reaches CUDA); the CUDA kernel itself is held against the
same plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py. Inputs are made with numpy from a seed and fed to both
packages; weights cross through convert.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.models.common import lstm_init, lstm_scan
from sitewhere_tpu.ops.lstm_kernel import _pallas_final
from sitewhere_tpu_torch.convert import params_from_numpy
from sitewhere_tpu_torch.ops import lstm_kernel
from sitewhere_tpu_torch.ops.lstm_kernel import (
    lstm_window_final,
    lstm_window_final_plain,
)


def _params(seed: int, hidden: int):
    p = jax.tree.map(np.asarray, lstm_init(jax.random.PRNGKey(seed), 1, hidden))
    return p, params_from_numpy(p, "cpu")


def _pallas(p, xn):
    return np.asarray(_pallas_final(
        jnp.asarray(xn), jnp.asarray(p["wx"]).astype(jnp.bfloat16),
        jnp.asarray(p["wh"]).astype(jnp.bfloat16),
        jnp.asarray(p["b"]).reshape(1, -1), interpret=True))


def test_plain_matches_pallas_kernel_interpret():
    """Same bf16 operands and f32 accumulation as the Pallas kernel: the
    two differ only in summation order and the bf16 flips of h that
    order causes (measured 4e-4 at this shape). atol 2e-3."""
    p, tp = _params(0, 64)
    xn = np.random.default_rng(0).standard_normal((256, 63)).astype(np.float32)
    want = _pallas(p, xn)
    got = lstm_window_final(tp, torch.from_numpy(xn), torch.bfloat16).numpy()
    assert got.shape == want.shape == (256, 64)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize("batch,steps", [(64, 63), (300, 31)])
def test_plain_matches_scan_final_h(batch, steps):
    """Against the JAX scan path's final h, atol 3e-2 — the JAX
    package's own kernel-vs-scan bound (tests/test_pallas.py)."""
    p, tp = _params(1, 64)
    xn = np.random.default_rng(1).standard_normal((batch, steps)).astype(np.float32)
    _, (want, _) = lstm_scan(p, jnp.asarray(xn)[:, :, None], jnp.bfloat16)
    got = lstm_window_final(tp, torch.from_numpy(xn), torch.bfloat16).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=3e-2)


def test_ragged_batch_rows_are_independent():
    """A batch that no tile divides: every row equals the row computed
    alone (atol 1e-6: the CPU matmul may block a 1-row and a 300-row
    product differently, so the last bits of a sum can move), and
    matches the Pallas kernel on the tile-sized prefix (atol 2e-3)."""
    p, tp = _params(2, 64)
    xn = np.random.default_rng(2).standard_normal((300, 63)).astype(np.float32)
    full = lstm_window_final(tp, torch.from_numpy(xn), torch.bfloat16).numpy()
    for lo, hi in ((0, 1), (255, 300), (299, 300)):
        solo = lstm_window_final(tp, torch.from_numpy(xn[lo:hi]),
                                 torch.bfloat16).numpy()
        np.testing.assert_allclose(full[lo:hi], solo, atol=1e-6, rtol=0)
    np.testing.assert_allclose(full[:256], _pallas(p, xn[:256]), atol=2e-3)


def test_strided_view_is_taken_as_is():
    """The scorer hands over xn[:, :-1] of a [B, W] window without a
    copy; the view and a contiguous copy give identical results."""
    _, tp = _params(3, 32)
    xw = torch.from_numpy(
        np.random.default_rng(3).standard_normal((40, 32)).astype(np.float32))
    view = lstm_window_final(tp, xw[:, :-1], torch.bfloat16)
    copy = lstm_window_final(tp, xw[:, :-1].contiguous(), torch.bfloat16)
    assert torch.equal(view, copy)


def _bad_inputs():
    _, tp = _params(4, 32)
    xn = torch.zeros((8, 15), dtype=torch.float32)
    wh_bad = dict(tp, wh=tp["wh"][:, :64])
    wx_bad = dict(tp, wx=tp["wx"][:, :8])
    return {
        "float64 xn": (tp, xn.double(), torch.bfloat16),
        "3-d xn": (tp, xn[:, :, None], torch.bfloat16),
        "empty window": (tp, xn[:, :0], torch.bfloat16),
        "column-strided xn": (tp, xn[:, ::2], torch.bfloat16),
        "f32 compute dtype": (tp, xn, torch.float32),
        "wh not [h, 4h]": (wh_bad, xn, torch.bfloat16),
        "wx not [1, 4h]": (wx_bad, xn, torch.bfloat16),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_raises_on_what_it_does_not_take(case):
    params, xn, cdt = _bad_inputs()[case]
    with pytest.raises(ValueError):
        lstm_window_final(params, xn, cdt)


def test_cpu_path_never_counts_a_launch():
    _, tp = _params(5, 32)
    before = lstm_kernel.launches
    lstm_window_final(tp, torch.zeros((4, 7)), torch.bfloat16)
    assert lstm_kernel.launches == before


def test_plain_version_is_the_lstm_recurrence():
    """One step from zero state, written out by hand in float32 on
    bf16-exact inputs: the plain version is the fused i/f/g/o cell."""
    gen = torch.Generator().manual_seed(6)
    h = 8
    wx = torch.randn((1, 4 * h), generator=gen).bfloat16().float()
    wh = torch.randn((h, 4 * h), generator=gen).bfloat16().float()
    b = torch.randn(4 * h, generator=gen)
    x = torch.randn((5, 1), generator=gen).bfloat16().float()
    got = lstm_window_final_plain(wx, wh, b, x)
    gates = x @ wx + b
    i, f, g, o = gates.split(h, dim=1)
    c = torch.sigmoid(i) * torch.tanh(g)
    want = torch.sigmoid(o) * torch.tanh(c)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
