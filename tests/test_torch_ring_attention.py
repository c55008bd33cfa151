"""The port's ring attention (`sitewhere_tpu_torch/parallel/ring.py`)
against dense attention and against the JAX package's
`ring_attention_sharded`, on the cases of `tests/test_ring_attention.py`
(dense parity causal and non-causal, the validity mask, fully masked
rows, bfloat16 inputs).

The same numpy inputs go through both packages. The port's sequence axis
spans 8 logical CPU devices (`Mesh` of `cpu` repeated), the JAX one the
8 virtual host devices of `tests/conftest.py`. Tolerances are the JAX
test's: 2e-5 in float32, 0.06 for bf16 inputs against the f32 dense
reference; against JAX's bf16 ring (the same rounded products) 2e-5.
A mesh whose devices are distinct keys (`cpu` and `cpu:0`) makes every
rotation a real copy between two device keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from sitewhere_tpu.parallel.ring import (
    ring_attention_sharded as jax_ring_sharded,
)
from sitewhere_tpu_torch.parallel.mesh import Mesh
from sitewhere_tpu_torch.parallel.ring import (
    dense_attention,
    ring_attention,
    ring_attention_sharded,
)

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)


def _mesh(n=8, name="seq", devices=None):
    return Mesh(np.array(devices or ["cpu"] * n, dtype=object), (name,))


def _jmesh(n=8, name="seq"):
    return JMesh(np.array(jax.devices()[:n]), (name,))


def _qkv(seed, B, W, H, Dh):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, W, H, Dh)).astype(np.float32)
                 for _ in range(3))


def _port(q, k, v, valid, causal=False, mesh=None, dtype=torch.float32):
    t = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    return ring_attention_sharded(*t, torch.from_numpy(valid),
                                  mesh or _mesh(), "seq",
                                  causal=causal).numpy()


def _dense(q, k, v, valid, causal=False):
    return dense_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           torch.from_numpy(valid), causal=causal).numpy()


def _jax(q, k, v, valid, causal=False, dtype=jnp.float32):
    return np.asarray(jax_ring_sharded(
        *(jnp.asarray(a, dtype) for a in (q, k, v)), jnp.asarray(valid),
        _jmesh(), "seq", causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_dense_and_jax(causal):
    q, k, v = _qkv(0, 2, 64, 2, 8)
    valid = np.ones((2, 64), bool)
    out = _port(q, k, v, valid, causal)
    np.testing.assert_allclose(out, _dense(q, k, v, valid, causal), **TOL)
    np.testing.assert_allclose(out, _jax(q, k, v, valid, causal), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_over_distinct_device_keys(causal):
    """Every hop a copy between two device keys: the same result."""
    q, k, v = _qkv(4, 2, 32, 2, 8)
    valid = np.random.default_rng(5).random((2, 32)) > 0.2
    mesh = _mesh(devices=["cpu", "cpu:0"] * 2)
    np.testing.assert_allclose(_port(q, k, v, valid, causal, mesh),
                               _dense(q, k, v, valid, causal), **TOL)


def test_ring_respects_validity_mask():
    """Padded (invalid) timesteps must not contribute as keys."""
    q, k, v = _qkv(1, 1, 32, 1, 4)
    valid = (np.arange(32) >= 10)[None, :]   # first 10 slots are padding
    out = _port(q, k, v, valid)
    np.testing.assert_allclose(out, _dense(q, k, v, valid), **TOL)
    np.testing.assert_allclose(out, _jax(q, k, v, valid), **TOL)
    # perturbing masked k/v leaves the output identical
    k2, v2 = k.copy(), v.copy()
    k2[:, :10], v2[:, :10] = 999.0, -999.0
    np.testing.assert_allclose(_port(q, k2, v2, valid), out,
                               rtol=1e-6, atol=1e-6)


def test_ring_fully_masked_rows_are_zero():
    q, k, v = _qkv(2, 1, 16, 1, 4)
    valid = np.zeros((1, 16), bool)
    assert np.abs(_port(q, k, v, valid)).max() == 0.0
    assert np.abs(_dense(q, k, v, valid)).max() == 0.0
    assert np.abs(_jax(q, k, v, valid)).max() == 0.0


def test_ring_bfloat16_inputs():
    """bf16 q/k/v accumulate in f32: close to the f32 dense reference
    (the JAX test's bound) and to JAX's bf16 ring."""
    q, k, v = _qkv(3, 2, 64, 2, 8)
    valid = np.ones((2, 64), bool)
    out = _port(q, k, v, valid, dtype=torch.bfloat16)
    np.testing.assert_allclose(out, _dense(q, k, v, valid),
                               rtol=0.06, atol=0.06)
    np.testing.assert_allclose(out, _jax(q, k, v, valid,
                                         dtype=jnp.bfloat16), **TOL)


def test_ring_blocks_stay_on_their_devices_and_are_differentiable():
    """The primitive takes and returns one block a device; gradients flow
    back through the rotations."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in _qkv(6, 1, 16, 1, 4))
    valid = torch.ones((1, 16), dtype=torch.bool)
    blocks = ring_attention(*(list(t.chunk(4, 1)) for t in (q, k, v)),
                            list(valid.chunk(4, 1)), causal=True)
    assert len(blocks) == 4 and blocks[0].shape == (1, 4, 1, 4)
    torch.cat(blocks, 1).sum().backward()
    ref = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    dense_attention(*ref, valid, causal=True).sum().backward()
    for got, want in zip((q, k, v), ref):
        np.testing.assert_allclose(got.grad.numpy(), want.grad.numpy(),
                                   **TOL)


def test_window_must_divide_over_the_axis():
    q, k, v = _qkv(7, 1, 30, 1, 4)
    with pytest.raises(ValueError, match="split"):
        _port(q, k, v, np.ones((1, 30), bool))
