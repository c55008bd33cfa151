"""The port stands alone: `sitewhere_tpu_torch` (and `chip_smoke.py`)
import neither jax nor the JAX package, and the port's entry points
refuse to run silently on the CPU when no device is named."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sitewhere_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "sitewhere_tpu")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys\n"
        "import sitewhere_tpu_torch\n"
        "import sitewhere_tpu_torch.scoring.server, sitewhere_tpu_torch.models\n"
        "import sitewhere_tpu_torch.sim.simulator, sitewhere_tpu_torch.convert\n"
        "import sitewhere_tpu_torch.ops.build\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sitewhere_tpu')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")


def test_entry_points_without_device_raise(no_card):
    from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.persistence.telemetry import TelemetryStore
    from sitewhere_tpu_torch.scoring.ring import DeviceRing
    from sitewhere_tpu_torch.scoring.server import ScoringSession

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceRing()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model("lstm")
    model = build_model("lstm", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ScoringSession(model, TelemetryStore(), MetricsRegistry())


def test_kernel_build_is_keyed_on_source_and_stays_in_checkout(tmp_path,
                                                                monkeypatch):
    """The library path hashes the source and flags, and lies under the
    repository's gitignored build directory."""
    from sitewhere_tpu_torch.ops import build

    target = build._target("lstm_window")
    assert target.is_relative_to(ROOT / "build" / "torch_kernels")
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    fake = tmp_path / "csrc"
    fake.mkdir()
    (fake / "lstm_window.cu").write_text("// edited\n")
    monkeypatch.setattr(build, "CSRC", fake)
    assert build._target("lstm_window") != target


def test_chip_smoke_refuses_without_a_card(no_card):
    """Run alone with no card, the chip check fails and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_ring_rejects_nothing_silently_on_cpu():
    """With device='cpu' named, the ring runs and stays on the CPU."""
    from sitewhere_tpu_torch.scoring.ring import DeviceRing

    ring = DeviceRing(window=4, capacity=8, device="cpu")
    ring.load(np.arange(8, dtype=np.float32).reshape(2, 4), np.array([4, 2]))
    x, valid = ring.windows(np.array([0, 1]))
    assert x.device.type == "cpu"
    np.testing.assert_array_equal(x[0].numpy(), [0, 1, 2, 3])
    np.testing.assert_array_equal(valid[1].numpy(), [False, False, True, True])
    np.testing.assert_array_equal(x[1].numpy()[2:], [6, 7])
