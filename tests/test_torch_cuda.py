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


@pytest.mark.parametrize("batch,steps,hidden", [
    (256, 63, 64), (1000, 63, 64), (4096, 63, 64), (77, 31, 32)])
def test_kernel_matches_plain_on_card(cuda, batch, steps, hidden):
    """Same operands and f32 accumulation; sum order differs: atol 2e-3."""
    gen = torch.Generator().manual_seed(batch)
    p = _params(gen, hidden, cuda)
    xn = torch.randn((batch, steps + 1), generator=gen).to(cuda)[:, :-1]
    before = lstm_kernel.launches
    got = lstm_window_final(p, xn, torch.bfloat16)
    torch.cuda.synchronize()
    assert lstm_kernel.launches == before + 1
    want = lstm_window_final_plain(p["wx"], p["wh"], p["b"], xn)
    assert (got - want).abs().max().item() < 2e-3


def test_kernel_refuses_unbuilt_width(cuda):
    gen = torch.Generator().manual_seed(0)
    p = _params(gen, 16, cuda)
    with pytest.raises(ValueError):
        lstm_window_final(p, torch.zeros((4, 7), device=cuda), torch.bfloat16)
