"""FLW01 + DLQ01: the flow-control and dead-letter contracts.

FLW01 — every ingress edge charges the FlowController (the tenant-
isolation invariant). In the designated ingress modules, any function
that publishes (`.produce(...)` or `.process_payload(...)`) must, on the
same path, consult flow control: one of `admit_ingress`,
`charge_produced`, `admit_fair`, `_charge_quota`, or `_admit`. A new
protocol listener that forwards payloads without charging the quota is
exactly the regression this check exists to catch. Reported at the
function's `def` line (the contract is per-path, not per-call).

DLQ01 — every bus poll loop quarantines poison records (the
poison-isolation invariant). A `for` loop iterating a bus poll
(`consumer.poll(...)` / `poll_nowait(...)`, directly or via a variable
assigned from one) must wrap per-record handling in a `try` whose
handler routes to the DLQ helper (`dead_letter(...)` or
`quarantine(...)`) — and no statement touching the record may sit
outside that wrapper. Otherwise one malformed record kills the
consuming loop — and once the supervisor's restart budget drains on
the same record, the whole tenant engine goes LIFECYCLE_ERROR.
"""

from __future__ import annotations

import ast
from typing import Iterable

from sitewhere_tpu_torch.analysis.engine import Finding, Module, Project

# the ingress edges (relative to the package parent); keep in sync with
# docs/ANALYSIS.md when a new protocol module lands
INGRESS_MODULES = frozenset({
    "sitewhere_tpu_torch/services/mqtt.py",
    "sitewhere_tpu_torch/services/amqp.py",
    "sitewhere_tpu_torch/services/coap.py",
    "sitewhere_tpu_torch/services/stomp.py",
    "sitewhere_tpu_torch/services/websocket.py",
    "sitewhere_tpu_torch/services/event_sources.py",
    "sitewhere_tpu_torch/rest/api.py",
    "sitewhere_tpu_torch/kernel/kafka_endpoint.py",
    # the fused ingress fast lane publishes validated batches to the
    # inbound topic — an ingress edge like the staged validator it fuses
    "sitewhere_tpu_torch/kernel/fastlane.py",
})

# egress drain modules: the fused egress shard (kernel/egresslane.py)
# consumes from an in-memory queue instead of a bus poll, but the
# stakes are identical — one poison scored batch would kill the shard
# loop (then its restart budget). Modules listed here get their
# queue-drain `while` loops (a `.popleft()`/`.pop()` dequeue feeding
# per-record handling) held to the same DLQ01 quarantine contract as
# bus poll loops.
DRAIN_MODULES = frozenset({
    "sitewhere_tpu_torch/kernel/egresslane.py",
})

_PUBLISH_ATTRS = {"produce", "process_payload"}
_CONSULT_ATTRS = {"admit_ingress", "charge_produced", "admit_fair",
                  "_charge_quota", "_admit"}
_QUARANTINE_ATTRS = {"dead_letter", "quarantine"}
_POLL_ATTRS = {"poll", "poll_nowait"}
_POP_ATTRS = {"popleft", "pop"}


def _attr_calls(node: ast.AST) -> Iterable[ast.Call]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute):
            yield sub


def _own_body(fn: ast.AST) -> Iterable[ast.AST]:
    """Nodes lexically in `fn`, excluding nested function scopes."""
    stack: list[ast.AST] = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def check_flow_consult(module: Module, project: Project) -> Iterable[Finding]:
    if module.relpath not in INGRESS_MODULES:
        return
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        publishes = None
        consults = False
        for node in _own_body(fn):
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                if node.func.attr in _PUBLISH_ATTRS and publishes is None:
                    publishes = node
                if node.func.attr in _CONSULT_ATTRS:
                    consults = True
        if publishes is not None and not consults:
            kind = publishes.func.attr  # type: ignore[union-attr]
            yield Finding(
                path=module.relpath, line=fn.lineno, code="FLW01",
                message=(f"ingress function `{fn.name}` publishes "
                         f"(`.{kind}(...)` at line {publishes.lineno}) "
                         f"without consulting the FlowController on the "
                         f"same path"),
                hint="charge `admit_ingress`/`charge_produced` (or "
                     "`await admit_fair`) before publishing",
                qualname=module.qualname_at(fn.lineno))


def _poll_names(fn: ast.AST) -> set[str]:
    """Variables assigned (in this function) from a bus poll call."""
    names: set[str] = set()
    for node in _own_body(fn):
        if isinstance(node, ast.Assign):
            value = node.value
            if isinstance(value, ast.Await):
                value = value.value
            if isinstance(value, ast.Call) \
                    and isinstance(value.func, ast.Attribute) \
                    and value.func.attr in _POLL_ATTRS:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        names.add(tgt.id)
    return names


def _iterates_poll(loop: ast.For, poll_names: set[str]) -> bool:
    it = loop.iter
    if isinstance(it, ast.Name):
        return it.id in poll_names
    for sub in ast.walk(it):
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute) \
                and sub.func.attr in _POLL_ATTRS:
            return True
    return False


def _handler_quarantines(handler: ast.ExceptHandler) -> bool:
    for call in _attr_calls(handler):
        if call.func.attr in _QUARANTINE_ATTRS:  # type: ignore[union-attr]
            return True
    return False


def _catches_broadly(handler: ast.ExceptHandler) -> bool:
    """except: / except Exception / except (..., Exception, ...)."""
    t = handler.type
    if t is None:
        return True
    names = []
    for sub in ([t.elts if isinstance(t, ast.Tuple) else [t]][0]):
        if isinstance(sub, ast.Name):
            names.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            names.append(sub.attr)
    return any(n in ("Exception", "BaseException") for n in names)


def _is_protecting(try_node: ast.Try) -> bool:
    return any(_catches_broadly(h) and _handler_quarantines(h)
               for h in try_node.handlers)


def _target_names(target: ast.expr) -> set[str]:
    return {sub.id for sub in ast.walk(target) if isinstance(sub, ast.Name)}


def _drains_queue(loop: ast.While) -> bool:
    """Does the loop's direct body pop records off a queue?"""
    for stmt in loop.body:
        if isinstance(stmt, ast.Assign):
            value = stmt.value
            if isinstance(value, ast.Call) \
                    and isinstance(value.func, ast.Attribute) \
                    and value.func.attr in _POP_ATTRS:
                return True
    return False


def check_dlq_quarantine(module: Module, project: Project) -> Iterable[Finding]:
    for fn in ast.walk(module.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if module.relpath in DRAIN_MODULES:
            # queue-drain while-loops: wrapper existence only — the
            # pop itself (own deque) can't raise on a poison record,
            # and statements after the try run post-publish, i.e.
            # after the batch proved processable
            for node in _own_body(fn):
                if not isinstance(node, ast.While) or not _drains_queue(node):
                    continue
                protected = any(
                    isinstance(inner, ast.Try) and _is_protecting(inner)
                    for sub in node.body for inner in ast.walk(sub))
                if not protected:
                    yield Finding(
                        path=module.relpath, line=node.lineno, code="DLQ01",
                        message="queue drain loop handles records without "
                                "the DLQ quarantine wrapper — one poison "
                                "batch kills this egress shard (then its "
                                "restart budget)",
                        hint="wrap per-batch handling in try/except "
                             "Exception routing to `engine.dead_letter("
                             "record, exc, self.path)`",
                        qualname=module.qualname_at(node.lineno))
        poll_names = _poll_names(fn)
        for node in _own_body(fn):
            if not isinstance(node, ast.For) \
                    or not _iterates_poll(node, poll_names):
                continue
            protected = any(
                isinstance(inner, ast.Try) and _is_protecting(inner)
                for sub in node.body for inner in ast.walk(sub))
            if not protected:
                yield Finding(
                    path=module.relpath, line=node.lineno, code="DLQ01",
                    message="bus poll loop handles records without the "
                            "DLQ quarantine wrapper — one poison record "
                            "kills this consumer (then its restart "
                            "budget)",
                    hint="wrap per-record handling in try/except "
                         "Exception routing to `engine.dead_letter("
                         "record, exc, self.path)`",
                    qualname=module.qualname_at(node.lineno))
                continue
            # the wrapper exists, but a statement that touches the
            # record OUTSIDE it (a decode before the try, a post-try
            # commit keyed on the record) re-opens the same hole: a
            # poison record raising there still kills the consumer
            record_names = _target_names(node.target)
            for stmt in node.body:
                if any(isinstance(inner, ast.Try) and _is_protecting(inner)
                       for inner in ast.walk(stmt)):
                    continue  # this statement IS (or holds) the wrapper
                exposed = next(
                    (sub for sub in ast.walk(stmt)
                     if isinstance(sub, ast.Name)
                     and sub.id in record_names), None)
                if exposed is not None:
                    yield Finding(
                        path=module.relpath, line=stmt.lineno, code="DLQ01",
                        message=f"record `{exposed.id}` is handled outside "
                                f"the DLQ quarantine wrapper — a poison "
                                f"record raising here still kills this "
                                f"consumer",
                        hint="move every statement touching the record "
                             "inside the quarantining try",
                        qualname=module.qualname_at(stmt.lineno))
