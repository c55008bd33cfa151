"""The port's CUDA kernel against its plain version, and the pooled
streaming step against the same step on the CPU, on the card.

Imports torch and the port only (no jax, so it runs on a machine with
the card but without the JAX package):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda

Without a card every test here skips with its reason.
"""

import pytest
import torch

from sitewhere_tpu_torch.ops import lstm_kernel
from sitewhere_tpu_torch.ops.lstm_kernel import (
    lstm_window_final,
    lstm_window_final_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(gen, hidden, device):
    return {"wx": torch.randn((1, 4 * hidden), generator=gen).to(device),
            "wh": (torch.randn((hidden, 4 * hidden), generator=gen)
                   / hidden ** 0.5).to(device),
            "b": torch.randn(4 * hidden, generator=gen).to(device)}


def _check(device, batch, steps, hidden):
    """Kernel vs plain on a row-strided xn[:, :-1] view; one launch per
    call. Same operands and f32 accumulation, sums in another order:
    atol 2e-3 on h."""
    gen = torch.Generator().manual_seed(1000 * hidden + batch + steps)
    p = _params(gen, hidden, device)
    xn = torch.randn((batch, steps + 1), generator=gen).to(device)[:, :-1]
    before = lstm_kernel.launches
    got = lstm_window_final(p, xn, torch.bfloat16)
    torch.cuda.synchronize()
    assert lstm_kernel.launches == before + 1
    assert got.shape == (batch, hidden) and got.dtype == torch.float32
    want = lstm_window_final_plain(p["wx"], p["wh"], p["b"], xn)
    assert (got - want).abs().max().item() < 2e-3


@pytest.mark.parametrize("hidden", [8, 16, 32, 64])
@pytest.mark.parametrize("batch", [1, 15, 17, 256, 300, 1000, 4096])
def test_kernel_matches_plain_on_card(cuda, batch, hidden):
    """Every width at ragged and full tiles and the main path's small
    buckets, at the window's T = 63."""
    _check(cuda, batch, 63, hidden)


@pytest.mark.parametrize("hidden", [8, 16, 32, 64])
@pytest.mark.parametrize("batch,steps", [(300, 97), (1000, 5), (77, 31),
                                         (16384, 63)])
def test_kernel_other_steps_and_buckets(cuda, batch, steps, hidden):
    """T past one 64-step x chunk, a short T, an odd T at a ragged
    batch, and the largest bucket."""
    _check(cuda, batch, steps, hidden)


def test_kernel_refuses_unbuilt_width(cuda):
    gen = torch.Generator().manual_seed(0)
    p = _params(gen, 96, cuda)
    before = lstm_kernel.launches
    with pytest.raises(ValueError):
        lstm_window_final(p, torch.zeros((4, 7), device=cuda), torch.bfloat16)
    assert lstm_kernel.launches == before


def test_kernel_refuses_bf16_weights(cuda):
    """The kernel reads float32 params and rounds them itself."""
    gen = torch.Generator().manual_seed(1)
    p = _params(gen, 64, cuda)
    p["wh"] = p["wh"].bfloat16()
    with pytest.raises(ValueError):
        lstm_window_final(p, torch.zeros((4, 7), device=cuda), torch.bfloat16)


@pytest.mark.parametrize("hidden", [8, 16])
def test_narrow_lstm_session_scores_on_card(cuda, hidden):
    """A CUDA session for an `lstm` model at a width the service and model
    tests configure scores through the kernel (one launch per dispatch)
    and agrees with the same model's plain CPU path: the kernel's h
    differs by < 2e-3, the head and the float32 readback keep scores
    within 1e-2."""
    import asyncio

    import numpy as np

    from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
    from sitewhere_tpu_torch.scoring.server import ScoringConfig, ScoringSession
    from sitewhere_tpu_torch.sim.simulator import DeviceSimulator, SimConfig

    async def main():
        store = TelemetryStore(history=64)
        sim = DeviceSimulator(SimConfig(num_devices=50, seed=hidden),
                              tenant_id="t")
        for k in range(20):
            store.append_measurements(sim.tick(t=60.0 * k)[0])
        model = build_model("lstm", window=16, hidden=hidden)
        assert model.fused
        session = ScoringSession(model, store, MetricsRegistry(),
                                 ScoringConfig(buckets=(64,),
                                               batch_window_ms=0.0,
                                               score_dtype="float32"))
        session.warmup()
        batch, _ = sim.tick(t=60.0 * 21)
        store.append_measurements(batch)
        session.admit(batch)
        before = lstm_kernel.launches
        scored = await session.flush()
        assert lstm_kernel.launches == before + 1
        assert len(scored) == 50 and np.isfinite(scored.score).all()
        x, valid = session.ring.windows(scored.device_index)
        cpu = build_model("lstm", device="cpu", window=16, hidden=hidden)
        params = {k: {n: t.cpu() for n, t in v.items()}
                  for k, v in session.params.items()}
        want = cpu.score_fused(params, x.cpu(), valid.cpu()).numpy()
        np.testing.assert_allclose(scored.score, want, atol=1e-2)
        await session.drain()

    asyncio.run(main())


def _stacked_rings(device, tenants, batch, seed):
    """A stacked streaming ring on `device` for `tenants` tenants (their
    own weights, seeded from the same host windows) and its param stack."""
    import numpy as np

    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.parallel import TenantStack
    from sitewhere_tpu_torch.scoring.stream import StackedStreamingRing

    model = build_model("lstm-stream", device=device)
    stack = TenantStack(model, device=device)
    for t in range(tenants):
        stack.add_tenant(f"t{t}", build_model("lstm-stream", device="cpu")
                         .init(torch.Generator().manual_seed(seed + t)))
    ring = StackedStreamingRing(model, stack.capacity, device_cap=batch,
                                device=device)
    rng = np.random.default_rng(seed)
    x = rng.normal(20.0, 2.0, (batch, 64)).astype(np.float32)
    count = rng.integers(8, 65, batch)  # enough history to score
    for t in range(tenants):
        ring.load_tenant(t, x, count, stack.get_params(f"t{t}"))
    return model, stack, ring


@pytest.mark.parametrize("tenants", [1, 8])
@pytest.mark.parametrize("batch", [1, 300, 4096])
def test_stacked_streaming_ring_on_card_matches_cpu(cuda, batch, tenants):
    """The pooled streaming step (gather → vmapped step_score → scatter)
    on the card against the same ring on the CPU, at the default width
    (W=64, h=64, bf16): seeded state, two steps' scores (the second with
    spikes) and every state leaf within 1e-2 — the matmuls round to bf16
    in the same place on both, and a different f32 summation order may
    flip a rounding."""
    import numpy as np

    card = _stacked_rings(cuda, tenants, batch, seed=batch + tenants)
    host = _stacked_rings("cpu", tenants, batch, seed=batch + tenants)
    rng = np.random.default_rng(batch)
    for step in range(2):
        dev = np.stack([rng.permutation(batch) for _ in range(tenants)])
        dev = dev.astype(np.int32)
        v = rng.normal(20.0, 2.0, dev.shape).astype(np.float32)
        v[:, ::7] += 30.0 * step
        outs = [ring.update_and_score(model, stack.stacked, dev, v).cpu()
                for model, stack, ring in (card, host)]
        torch.testing.assert_close(outs[0], outs[1], atol=1e-2, rtol=0)
        if step:
            assert outs[0][:, ::7].min() > 4.0
    for k, leaf in card[2].state.items():
        torch.testing.assert_close(leaf.cpu(), host[2].state[k], atol=1e-2,
                                   rtol=0, msg=k)


def test_out_of_range_id_refused_before_launch(cuda):
    """An id past the scratch row is refused on the host: no launch, no
    device-side assert, the CUDA context and the state intact."""
    import numpy as np

    model, stack, ring = _stacked_rings(cuda, 2, 16, seed=0)
    before = {k: v.clone() for k, v in ring.state.items()}
    dev = np.full((stack.capacity, 4), ring.device_cap, np.int32)
    dev[1, 2] = ring.device_cap + 1
    with pytest.raises(IndexError):
        ring.update_and_score(model, stack.stacked, dev,
                              np.zeros(dev.shape, np.float32))
    torch.cuda.synchronize()  # the context survived
    for k, v in before.items():
        assert torch.equal(ring.state[k], v), k
    dev[1, 2] = 3
    out = ring.update_and_score(model, stack.stacked, dev,
                                np.zeros(dev.shape, np.float32))
    assert out.shape == dev.shape and torch.isfinite(out.float()).all()
