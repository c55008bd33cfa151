"""FLT01 + MET01: fault-site and metric-name literals resolve against
the central registry (analysis/registry.py).

Both contracts say "sites are bare string literals" — greppable, and
now machine-checked: a typo like `faults.check("flow.admitt")` or a
counter read back as a gauge fails the build instead of silently never
firing / TypeError-ing at runtime.

FLT01 — `<...>.check/acheck/arm("site")` where the receiver chain ends
in a fault-injector-ish name must pass a string literal that is in
`FAULT_SITES`. A computed site is itself a finding: the registry can
only vouch for literals.

MET01 — `<...>.metrics.counter/gauge/meter/histogram(name)`: the base
name (before any `:{tenant}` suffix) must be registered, under the SAME
kind as the call. f-strings resolve by their literal prefix: a prefix
ending in `:` is the per-tenant convention (`f"dlq.quarantined:{t}"`),
anything else must exactly match a registered dynamic family prefix
(`f"flow.{name}"` — FlowController.count's families).
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from sitewhere_tpu_torch.analysis.engine import Finding, Module, Project
from sitewhere_tpu_torch.analysis.registry import (
    DYNAMIC_METRIC_PREFIXES,
    FAULT_SITES,
    METRICS,
)

_FAULT_ATTRS = {"check", "acheck", "arm"}
_METRIC_ATTRS = {"counter", "gauge", "meter", "histogram"}


def _receiver_last(func: ast.Attribute) -> Optional[str]:
    """Final identifier of the receiver chain (`self.runtime.metrics`
    -> "metrics"; `metrics` -> "metrics")."""
    recv = func.value
    if isinstance(recv, ast.Name):
        return recv.id
    if isinstance(recv, ast.Attribute):
        return recv.attr
    return None


def is_fault_receiver(recv: Optional[str]) -> bool:
    """Does the receiver name look like a FaultInjector? Shared with
    `--dump-registry` so the regeneration aid and the checkers agree on
    what counts as a fault site."""
    if recv is None:
        return False
    low = recv.lower()
    return "fault" in low or "injector" in low or low == "fi"


def is_metrics_receiver(recv: Optional[str]) -> bool:
    """Is the receiver the instance MetricsRegistry? Shared with
    `--dump-registry` for the same reason."""
    return recv in ("metrics", "_metrics")


def check_fault_sites(module: Module, project: Project) -> Iterable[Finding]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _FAULT_ATTRS or not node.args:
            continue
        if not is_fault_receiver(_receiver_last(node.func)):
            continue  # receiver is not a FaultInjector
        arg = node.args[0]
        qual = module.qualname_at(node.lineno)
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            yield Finding(
                path=module.relpath, line=node.lineno, code="FLT01",
                message=f"fault site passed to `.{node.func.attr}()` must "
                        f"be a bare string literal (the registry can only "
                        f"vouch for literals)",
                hint="pass the site name inline and register it in "
                     "analysis/registry.py FAULT_SITES",
                qualname=qual)
            continue
        if arg.value not in FAULT_SITES:
            yield Finding(
                path=module.relpath, line=node.lineno, code="FLT01",
                message=f"fault site {arg.value!r} is not in the central "
                        f"registry",
                hint="fix the typo or add the site to "
                     "analysis/registry.py FAULT_SITES",
                qualname=qual)


def _metric_base(arg: ast.expr) -> tuple[Optional[str], Optional[str]]:
    """(base_name, problem): base_name resolved from a literal or
    f-string prefix; `problem` set when the name is structurally
    uncheckable."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value.split(":", 1)[0], None
    if isinstance(arg, ast.JoinedStr):
        lead = ""
        for part in arg.values:
            if isinstance(part, ast.Constant):
                lead += str(part.value)
            else:
                break
        if lead.endswith(":"):
            return lead[:-1], None      # f"name:{tenant}" convention
        if lead in DYNAMIC_METRIC_PREFIXES:
            return None, None           # registered dynamic family: OK
        return None, (f"f-string metric name must start with a registered "
                      f"base + ':' or a dynamic family prefix "
                      f"(got leading literal {lead!r})")
    return None, ("metric name must be a string literal or a literal-"
                  "prefixed f-string")


def check_metric_names(module: Module, project: Project) -> Iterable[Finding]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _METRIC_ATTRS or not node.args:
            continue
        if not is_metrics_receiver(_receiver_last(node.func)):
            continue  # not the instance MetricsRegistry
        kind = node.func.attr
        qual = module.qualname_at(node.lineno)
        base, problem = _metric_base(node.args[0])
        if problem is not None:
            yield Finding(path=module.relpath, line=node.lineno,
                          code="MET01", message=problem,
                          hint="see analysis/registry.py",
                          qualname=qual)
            continue
        if base is None:
            continue  # dynamic family, vouched for by the registry
        registered = METRICS.get(base)
        if registered is None:
            yield Finding(
                path=module.relpath, line=node.lineno, code="MET01",
                message=f"metric {base!r} is not in the central registry",
                hint=f"fix the typo or register it in analysis/registry.py "
                     f"({kind.upper()}S)",
                qualname=qual)
        elif registered != kind:
            yield Finding(
                path=module.relpath, line=node.lineno, code="MET01",
                message=f"metric {base!r} is registered as a {registered} "
                        f"but used here as a {kind}",
                hint="one name, one kind — rename one of the two uses",
                qualname=qual)
