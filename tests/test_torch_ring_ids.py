"""Out-of-range device ids: the port's four rings refuse them on the host
with `IndexError` before any launch (on the card an out-of-range index
is a device-side assert that ends the process's CUDA context); the JAX
rings scatter with `mode="drop"` and leave the ring as it was. Both
behaviours are pinned here; ROADMAP C lists the difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sitewhere_tpu.models import build_model as jax_build
from sitewhere_tpu.scoring.ring import DeviceRing as JDeviceRing
from sitewhere_tpu.scoring.stream import StreamingRing as JStreamingRing
from sitewhere_tpu_torch.models import build_model
from sitewhere_tpu_torch.parallel import TenantStack
from sitewhere_tpu_torch.scoring.ring import DeviceRing, StackedDeviceRing
from sitewhere_tpu_torch.scoring.stream import (
    StackedStreamingRing,
    StreamingRing,
)

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

W, H, CAP = 16, 8, 1024


def _history(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.normal(20.0, 2.0, (n, W)).astype(np.float32),
            np.full(n, W, np.int64))


def _snapshot(ring) -> list[np.ndarray]:
    if hasattr(ring, "state"):
        return [ring.state[k].clone().numpy() for k in sorted(ring.state)]
    return [t.clone().numpy() for t in (ring.values, ring.count, ring.cursor)]


def _dedicated():
    model = build_model("zscore", device="cpu", window=W)
    ring = DeviceRing(W, capacity=CAP, device="cpu")
    ring.load(*_history(8))
    return ring, lambda dev: ring.update_and_score(
        model, {}, dev, np.ones(dev.shape[0], np.float32), dev.shape[0])


def _streaming():
    model = build_model("lstm-stream", device="cpu", window=W, hidden=H)
    params = model.init()
    ring = StreamingRing(model, capacity=CAP, device="cpu")
    ring.bind_params(params)
    ring.load(*_history(8))
    return ring, lambda dev: ring.update_and_score(
        model, params, dev, np.ones(dev.shape[0], np.float32), dev.shape[0])


def _stacked_window():
    model = build_model("zscore", device="cpu", window=W)
    stack = TenantStack(model, device="cpu")
    stack.add_tenant("a")
    ring = StackedDeviceRing(W, stack.capacity, device_cap=CAP, device="cpu")
    ring.load_tenant(0, *_history(8))
    return ring, lambda dev: ring.update_and_score(
        model, stack.stacked, dev[None], np.ones((1, dev.shape[0]),
                                                 np.float32))


def _stacked_streaming():
    model = build_model("lstm-stream", device="cpu", window=W, hidden=H)
    stack = TenantStack(model, device="cpu")
    stack.add_tenant("a")
    ring = StackedStreamingRing(model, stack.capacity, device_cap=CAP,
                                device="cpu")
    ring.load_tenant(0, *_history(8), params=stack.get_params("a"))
    return ring, lambda dev: ring.update_and_score(
        model, stack.stacked, dev[None], np.ones((1, dev.shape[0]),
                                                 np.float32))


RINGS = {"dedicated": _dedicated, "streaming": _streaming,
         "stacked-window": _stacked_window,
         "stacked-streaming": _stacked_streaming}
# past the last row a dispatch may name (the stacked rings' scratch row
# `CAP` is a legal padding target), and negative
BAD = {"past-the-end": CAP + 5, "negative": -1}


@pytest.mark.parametrize("bad", list(BAD))
@pytest.mark.parametrize("ring", list(RINGS))
def test_port_ring_refuses_an_out_of_range_id(ring, bad):
    r, step = RINGS[ring]()
    before = _snapshot(r)
    dev = np.asarray([3, BAD[bad]], np.int64)
    with pytest.raises(IndexError, match="outside the ring's rows"):
        step(dev)
    # refused on the host, before any write
    assert all(np.array_equal(a, b) for a, b in zip(before, _snapshot(r)))
    assert not r.faulted
    # and the ring still scores in-range ids
    assert step(np.asarray([3], np.int64)).shape[-1] == 1


def _jax_dedicated():
    model = jax_build("zscore", window=W)
    ring = JDeviceRing(W, capacity=CAP)
    ring.load(*_history(8))
    return ring, (lambda: [np.asarray(a) for a in
                           (ring.values, ring.count, ring.cursor)]), \
        lambda dev: ring.update_and_score(
            model, {}, dev, np.ones(dev.shape[0], np.float32), dev.shape[0])


def _jax_streaming():
    model = jax_build("lstm-stream", window=W, hidden=H,
                      compute_dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0))
    ring = JStreamingRing(model, capacity=CAP)
    ring.bind_params(params)
    ring.load(*_history(8))
    return ring, (lambda: [np.asarray(ring.state[k])
                           for k in sorted(ring.state)]), \
        lambda dev: ring.update_and_score(
            model, params, dev, np.ones(dev.shape[0], np.float32),
            dev.shape[0])


@pytest.mark.parametrize("ring", ["dedicated", "streaming"])
def test_jax_ring_drops_the_same_id(ring):
    """The reference drops an id past its rows: the dispatch succeeds and
    the ring — every row, the scratch row included — is unchanged."""
    r, snap, step = {"dedicated": _jax_dedicated,
                     "streaming": _jax_streaming}[ring]()
    before = snap()
    scores = np.asarray(step(np.asarray([CAP + 5], np.int32)))
    assert scores.shape == (1,)
    assert all(np.array_equal(a, b) for a, b in zip(before, snap()))
