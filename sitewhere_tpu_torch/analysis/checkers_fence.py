"""FEN01: the epoch-fencing contract on the fleet data path.

Epoch fencing (docs/FLEET.md) only closes the dual-ownership window if
EVERY data-path write a tenant owner makes carries the fencing token —
one unfenced `produce`/`commit` is a channel a zombie owner can still
write through after its tenant moved. In the fleet-managed tenant
modules (the worker colocation set plus the shared kernel lanes and the
DLQ helper), every `.produce(...)`, `.produce_nowait(...)`, and
`.commit(...)` call must therefore thread a `fence=` keyword — the
engine's live token (`TenantEngine.fence_token()`), a passed-through
parameter, or an explicit `fence=None` on a path that is genuinely
control-plane (the explicitness IS the review hook).

Same machinery as FLW01/DLQ01: same-line `# swxlint: disable=FEN01`
suppression with justification, baseline entries with reasons for
documented false positives.
"""

from __future__ import annotations

import ast
from typing import Iterable

from sitewhere_tpu_torch.analysis.engine import Finding, Module, Project

# the fleet-managed tenant data-path modules: the worker colocation set
# (fleet/worker_main.py services) + the fused kernel lanes + the DLQ
# helper + the replicated-state publisher. Keep in sync with
# docs/ANALYSIS.md when the colocation set grows.
FENCED_MODULES = frozenset({
    "sitewhere_tpu_torch/kernel/fastlane.py",
    "sitewhere_tpu_torch/kernel/egresslane.py",
    "sitewhere_tpu_torch/kernel/dlq.py",
    "sitewhere_tpu_torch/services/rule_processing.py",
    "sitewhere_tpu_torch/services/inbound_processing.py",
    "sitewhere_tpu_torch/services/event_management.py",
    "sitewhere_tpu_torch/services/device_state.py",
    "sitewhere_tpu_torch/services/device_registration.py",
    "sitewhere_tpu_torch/services/replication.py",
})

_DATA_CALLS = {"produce", "produce_nowait", "commit"}


def check_fence_token(module: Module, project: Project) -> Iterable[Finding]:
    if module.relpath not in FENCED_MODULES:
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _DATA_CALLS:
            continue
        if any(kw.arg == "fence" for kw in node.keywords):
            continue
        kind = node.func.attr
        yield Finding(
            path=module.relpath, line=node.lineno, code="FEN01",
            message=(f"data-path `.{kind}(...)` in a fleet-managed tenant "
                     f"module does not thread the fencing token — a "
                     f"zombie owner could still write through this call "
                     f"after its tenant moved"),
            hint="pass `fence=engine.fence_token()` (or the caller's "
                 "fence parameter; `fence=None` explicitly on genuine "
                 "control-plane paths)",
            qualname=module.qualname_at(node.lineno))
