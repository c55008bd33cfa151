"""The port's CUDA kernel against its plain version, on the card.

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
