"""TRC01: the tracing-parity contract (and stage-name resolution).

The pipeline flight recorder's trace spine (kernel/tracing.py) is only
as complete as its call sites: hot-path work has moved before (fused
ingress, fused egress, megabatch dispatch) without moving the spans,
and `Tracer.trace(id)` went dark exactly where the work went. This
check makes span coverage a build-time contract, mirroring FLW01's
shape:

- **parity** — in the designated consumer hot-path modules, any
  function that emits pipeline output (`.produce(...)` /
  `.produce_nowait(...)`) or persists a batch (`.add_measurements` /
  `.add_locations`) must, on the same path, record a span
  (`<...>tracer.record(...)` or `with <...>tracer.span(...)`). A new hot-path hop that forwards batches
  without a span is exactly the regression this exists to catch.
  Reported at the function's `def` line (the contract is per-path, not
  per-call). Justified gaps — cold API surfaces with no batch ctx,
  helpers whose caller owns the span — ride the reasoned baseline.
- **stage names** — every literal passed to `tracer.record(trace_id,
  "stage", ...)` or `tracer.span("stage", ...)` must resolve against
  the central inventory
  (`analysis/registry.py` TRACE_STAGES), exactly as MET01 resolves
  metric names: a typo'd stage silently vanishes from the critical-path
  report instead of failing the build. A computed stage is itself a
  finding — the registry can only vouch for literals.
"""

from __future__ import annotations

import ast
from typing import Iterable

from sitewhere_tpu_torch.analysis.engine import Finding, Module, Project
from sitewhere_tpu_torch.analysis.checkers_flow import _own_body
from sitewhere_tpu_torch.analysis.checkers_registry import _receiver_last
from sitewhere_tpu_torch.analysis.registry import TRACE_STAGE_KINDS

# the consumer hot-path modules under the parity contract; keep in sync
# with docs/OBSERVABILITY.md when a new pipeline hop lands
TRACE_MODULES = frozenset({
    "sitewhere_tpu_torch/services/event_sources.py",
    "sitewhere_tpu_torch/services/inbound_processing.py",
    "sitewhere_tpu_torch/services/event_management.py",
    "sitewhere_tpu_torch/services/rule_processing.py",
    "sitewhere_tpu_torch/kernel/fastlane.py",
    "sitewhere_tpu_torch/kernel/egresslane.py",
    "sitewhere_tpu_torch/kernel/dlq.py",
    "sitewhere_tpu_torch/scoring/server.py",
    "sitewhere_tpu_torch/scoring/pool.py",
    "sitewhere_tpu_torch/rest/api.py",
    # fleet observability: the beat's telemetry export publishes on the
    # same path it records its fleet.telemetry span
    "sitewhere_tpu_torch/kernel/observe.py",
})

# wire-boundary modules (the process-split data plane): a batch context
# REBUILT here without threading `trace_id=` silently snaps the
# cross-process trace back into per-process fragments — the exact
# regression the fleet trace propagation exists to prevent. The codec
# round-trips dataclass fields wholesale, so the live tree has no such
# rebuild; this check keeps it that way.
WIRE_MODULES = frozenset({
    "sitewhere_tpu_torch/kernel/wire.py",
    "sitewhere_tpu_torch/kernel/codec.py",
})

_CTX_CLASSES = {"BatchContext"}

_EMIT_ATTRS = {"produce", "produce_nowait",
               "add_measurements", "add_locations"}

# the tracer's write paths and the position of the stage argument
_RECORD_ATTRS = {"record": 1, "span": 0}


def _is_tracer_receiver(recv: str | None) -> bool:
    """Does the receiver chain end in a Tracer? (`runtime.tracer`,
    `self.tracer`, bare `tracer` — the platform convention.)"""
    return recv is not None and "tracer" in recv.lower()


def check_trace_parity(module: Module, project: Project) -> Iterable[Finding]:
    if module.relpath not in TRACE_MODULES:
        return
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        emits = None
        records = False
        for node in _own_body(fn):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                if node.func.attr in _EMIT_ATTRS and emits is None:
                    emits = node
                if node.func.attr in _RECORD_ATTRS \
                        and _is_tracer_receiver(_receiver_last(node.func)):
                    records = True
        if emits is not None and not records:
            kind = emits.func.attr  # type: ignore[union-attr]
            yield Finding(
                path=module.relpath, line=fn.lineno, code="TRC01",
                message=(f"hot-path function `{fn.name}` emits "
                         f"(`.{kind}(...)` at line {emits.lineno}) "
                         f"without recording a span on the same path — "
                         f"`Tracer.trace(id)` goes dark at this hop"),
                hint="record a span (`tracer.record(trace_id, "
                     "\"<stage>\", ...)`) on the same path, or baseline "
                     "with a reason if the caller owns the span",
                qualname=module.qualname_at(fn.lineno))


def check_wire_trace_context(module: Module,
                             project: Project) -> Iterable[Finding]:
    """TRC01 at the wire boundary: constructing a fresh `BatchContext`
    inside the wire/codec modules without `trace_id=` drops the trace
    context a traveling batch carried — every downstream span lands on
    id 0 and the fleet-stitched journey goes dark at the hop."""
    if module.relpath not in WIRE_MODULES:
        return
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else None)
        if name not in _CTX_CLASSES:
            continue
        kwargs = {kw.arg for kw in node.keywords}
        if "trace_id" in kwargs or None in kwargs:  # **kwargs may carry it
            continue
        yield Finding(
            path=module.relpath, line=node.lineno, code="TRC01",
            message=(f"wire-boundary `{name}(...)` rebuild without "
                     f"`trace_id=` — a batch crossing this hop loses "
                     f"its trace context and the cross-process trace "
                     f"fragments"),
            hint="thread `trace_id=ctx.trace_id` (and the rest of the "
                 "traveling context) through the rebuild, or baseline "
                 "with a reason if this context never carries a trace",
            qualname=module.qualname_at(node.lineno))


def check_trace_stages(module: Module, project: Project) -> Iterable[Finding]:
    for node in ast.walk(module.tree):
        if not isinstance(node, ast.Call) \
                or not isinstance(node.func, ast.Attribute) \
                or node.func.attr not in _RECORD_ATTRS \
                or len(node.args) <= _RECORD_ATTRS[node.func.attr]:
            continue
        if not _is_tracer_receiver(_receiver_last(node.func)):
            continue
        arg = node.args[_RECORD_ATTRS[node.func.attr]]
        qual = module.qualname_at(node.lineno)
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            yield Finding(
                path=module.relpath, line=node.lineno, code="TRC01",
                message=f"trace stage passed to `tracer.{node.func.attr}()` "
                        f"must be a bare string literal (the registry can "
                        f"only vouch for literals)",
                hint="pass the stage name inline and register it in "
                     "analysis/registry.py TRACE_STAGES",
                qualname=qual)
            continue
        if arg.value not in TRACE_STAGE_KINDS:
            yield Finding(
                path=module.relpath, line=node.lineno, code="TRC01",
                message=f"trace stage {arg.value!r} is not in the central "
                        f"registry — it would silently vanish from the "
                        f"critical-path report",
                hint="fix the typo or add the stage to "
                     "analysis/registry.py TRACE_STAGES",
                qualname=qual)
