"""The port stands alone: `sitewhere_tpu_torch` (and `chip_smoke.py`)
import neither jax nor the JAX package, and the port's entry points
refuse to run silently on the CPU when no device is named."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# the tier-1 run shares the host's cores between test workers
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sitewhere_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "orbax", "sitewhere_tpu")


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
        "import sitewhere_tpu_torch.scoring.pool, sitewhere_tpu_torch.parallel\n"
        "import sitewhere_tpu_torch.tools.main_path\n"
        "import sitewhere_tpu_torch.kernel.service, sitewhere_tpu_torch.services\n"
        "import sitewhere_tpu_torch.cli, sitewhere_tpu_torch.tools.pipeline\n"
        "import sitewhere_tpu_torch.history, sitewhere_tpu_torch.persistence.native\n"
        "import sitewhere_tpu_torch.services.replication\n"
        "import sitewhere_tpu_torch.services.snapshot\n"
        "import sitewhere_tpu_torch.training, sitewhere_tpu_torch.models.gnn\n"
        "import sitewhere_tpu_torch.models.graph, sitewhere_tpu_torch.parallel.ring\n"
        "import sitewhere_tpu_torch.rest, sitewhere_tpu_torch.domain.spi\n"
        "import sitewhere_tpu_torch.kernel.security, sitewhere_tpu_torch.utils.http\n"
        "import sitewhere_tpu_torch.kernel.templates\n"
        "import sitewhere_tpu_torch.services.geofence, sitewhere_tpu_torch.services.qrcode\n"
        "import sitewhere_tpu_torch.fleet, sitewhere_tpu_torch.fleet.worker_main\n"
        "import sitewhere_tpu_torch.parallel.placement, sitewhere_tpu_torch.tools.fleet\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'optax', 'orbax', 'sitewhere_tpu')]\n"
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


@pytest.mark.parametrize("entry", ["lstm-stream", "StreamingRing",
                                   "StackedStreamingRing", "StackedDeviceRing",
                                   "TenantStack", "SharedScoringPool"])
def test_streaming_and_pool_entry_points_without_device_raise(no_card, entry):
    from sitewhere_tpu_torch.kernel.metrics import MetricsRegistry
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.parallel import TenantStack
    from sitewhere_tpu_torch.scoring.pool import SharedScoringPool
    from sitewhere_tpu_torch.scoring.ring import StackedDeviceRing
    from sitewhere_tpu_torch.scoring.stream import (
        StackedStreamingRing,
        StreamingRing,
    )

    model = build_model("lstm-stream", device="cpu", window=8, hidden=8)
    make = {
        "lstm-stream": lambda: build_model("lstm-stream"),
        "StreamingRing": lambda: StreamingRing(model),
        "StackedStreamingRing": lambda: StackedStreamingRing(model, 1),
        "StackedDeviceRing": lambda: StackedDeviceRing(8, 1),
        "TenantStack": lambda: TenantStack(model),
        "SharedScoringPool": lambda: SharedScoringPool(model,
                                                       MetricsRegistry()),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


@pytest.mark.parametrize("entry", ["tft", "longwin", "seasonal", "gnn",
                                   "train"])
def test_models_and_training_without_device_raise(no_card, entry):
    """The new models, the GNN and `cli train` target the card unless the
    CPU is named: with no card they raise, nothing falls back."""
    from sitewhere_tpu_torch import cli
    from sitewhere_tpu_torch.models import build_model
    from sitewhere_tpu_torch.training import build_maintenance_model

    make = {
        "gnn": build_maintenance_model,
        "train": lambda: cli.main(["train", "--steps", "1"]),
    }.get(entry, lambda: build_model(entry))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_runtime_with_rule_processing_without_device_raises(no_card):
    """The scoring service resolves its device when it is built: with no
    card and no device named, the runtime refuses it at once."""
    from sitewhere_tpu_torch.config import InstanceSettings
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.services import RuleProcessingService

    rt = ServiceRuntime(InstanceSettings())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RuleProcessingService(rt)
    cpu = ServiceRuntime(InstanceSettings(device="cpu"))
    assert RuleProcessingService(cpu).device.type == "cpu"


def test_training_service_without_device_raises(no_card):
    """batch-operations trains and sweeps on the runtime's device: with
    no card and no device named it refuses at once, as rule-processing
    does; with the CPU named it trains there."""
    from sitewhere_tpu_torch.config import InstanceSettings
    from sitewhere_tpu_torch.kernel.service import ServiceRuntime
    from sitewhere_tpu_torch.services import BatchOperationsService

    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchOperationsService(ServiceRuntime(InstanceSettings()))
    cpu = ServiceRuntime(InstanceSettings(device="cpu"))
    assert BatchOperationsService(cpu).device.type == "cpu"


def test_demo_cli_serves_rest_with_all_fourteen_services(no_card):
    """`cli demo --port P` hosts all fourteen services and answers
    `GET /api/instance/health` on P while it streams."""
    import socket
    import time
    import urllib.request

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "sitewhere_tpu_torch.cli", "demo", "--cpu",
         "--devices", "64", "--seconds", "4", "--port", str(port)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        health = None
        deadline = time.monotonic() + 90
        while health is None and time.monotonic() < deadline:
            assert proc.poll() is None, proc.communicate()
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/api/instance/health",
                        timeout=5) as r:
                    assert r.status == 200
                    health = json.loads(r.read())
            except OSError:
                time.sleep(0.2)
        out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    assert health is not None, err
    from sitewhere_tpu_torch import cli, services as svc

    ids = {getattr(svc, name).identifier for name in cli.ALL_SERVICES}
    services = {c["name"] for c in health["children"]}
    assert len(ids) == 14 and ids <= services, sorted(services)
    report = json.loads(out[out.index("{"):])
    assert report["events_persisted"] == report["events_sent"] > 0


def test_demo_cli_needs_the_card_or_the_cpu_named(no_card):
    """`python -m sitewhere_tpu_torch.cli demo` with no card exits
    non-zero naming the missing device; with `--cpu` it runs the
    pipeline and prints its JSON report."""
    cmd = [sys.executable, "-m", "sitewhere_tpu_torch.cli", "demo",
           "--devices", "64", "--seconds", "1"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    out = subprocess.run(cmd + ["--cpu"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    report = json.loads(out.stdout[out.stdout.index("{"):])
    assert report["events_sent"] > 0
    assert report["events_persisted"] == report["events_sent"]


def test_replay_cli_needs_the_card_or_the_cpu_named(no_card, tmp_path):
    """`python -m sitewhere_tpu_torch.cli replay` with no card exits
    non-zero naming the missing device; with `--cpu` it gets as far as
    the data_dir (empty here: exit 2)."""
    cmd = [sys.executable, "-m", "sitewhere_tpu_torch.cli", "replay",
           "--data-dir", str(tmp_path), "--tenant", "t"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    out = subprocess.run(cmd + ["--cpu"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 2
    assert "no durable log or cold tier" in out.stderr


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
