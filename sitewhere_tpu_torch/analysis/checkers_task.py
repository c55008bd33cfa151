"""TSK01: every `asyncio.create_task(...)` result is retained and
supervised.

The event loop holds only a WEAK reference to tasks: a task whose result
is dropped can be garbage-collected mid-flight (the coroutine just
stops), and even when it survives, an exception it raises is never
retrieved — the failure is silent until the thing the task was supposed
to keep alive (prefetch credit, a megabatch settle, a retry drain)
wedges with no traceback. Both shapes have bitten this codebase's
neighbors; the checker makes retention a build-time contract:

- a bare `create_task(...)` / `ensure_future(...)` expression statement
  is a finding;
- `t = create_task(...)` where the local `t` is never used again in the
  function is a finding (the name changes nothing — the reference dies
  with the frame);
- anything that hands the task onward is fine: assignment to an
  attribute/subscript (tracked state), `await`, `return`, passing it as
  an argument (`self._tasks.add(create_task(...))`,
  `add_done_callback` via a later use of the local, gather, shield).

Supervised spawn helpers (`WireClient.spawn`, lifecycle background
tasks) already retain + add a done callback — route new call sites
through them rather than suppressing. TaskGroup-style receivers
(`tg.create_task`) supervise structurally and are exempt.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from sitewhere_tpu_torch.analysis.engine import (
    Finding,
    FuncFlow,
    Module,
    Project,
    node_pos,
    own_body,
)

_SPAWN_ATTRS = {"create_task", "ensure_future"}
# receivers that supervise their tasks structurally (trio/anyio-style
# nurseries, asyncio.TaskGroup) — dropping the handle is the idiom there
_SUPERVISED_RECEIVERS = {"tg", "task_group", "taskgroup", "nursery",
                         "group"}


def _spawn_call(node: ast.AST, imports: dict[str, str]) -> Optional[ast.Call]:
    """`node` as a create_task/ensure_future call, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _SPAWN_ATTRS:
        recv = fn.value
        if isinstance(recv, ast.Name) \
                and recv.id.lower() in _SUPERVISED_RECEIVERS:
            return None
        return node
    if isinstance(fn, ast.Name):
        origin = imports.get(fn.id, "")
        if origin in ("asyncio.create_task", "asyncio.ensure_future"):
            return node
    return None


def _findings_for_flow(module: Module, flow: FuncFlow,
                       imports: dict[str, str]) -> Iterable[Finding]:
    # classify every spawn call by its syntactic position: bare Expr
    # statement and dead-local Assign are the two dropped-result shapes;
    # every other position hands the task onward (nested defs are their
    # own FuncFlow — own_body keeps each spawn attributed exactly once)
    for node in own_body(flow.node):
        if isinstance(node, ast.Expr):
            call = _spawn_call(node.value, imports)
            if call is not None:
                yield Finding(
                    path=module.relpath, line=call.lineno, code="TSK01",
                    message="create_task result is dropped — the loop "
                            "keeps only a weak reference, so the task can "
                            "be GC'd mid-flight and its exception is "
                            "never retrieved",
                    hint="retain it (`self._tasks.add(t)` + "
                         "`add_done_callback(self._tasks.discard)`) or "
                         "route through a supervised spawn helper",
                    qualname=module.qualname_at(call.lineno))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            value = node.value
            if value is None:
                continue
            call = _spawn_call(value, imports)
            if call is None:
                continue
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if len(targets) != 1 or not isinstance(targets[0], ast.Name):
                continue  # attribute/subscript target = tracked state
            name = targets[0].id
            if flow.loads_after(name, node_pos(node)):
                continue  # the local is used (awaited, registered, ...)
            yield Finding(
                path=module.relpath, line=call.lineno, code="TSK01",
                message=f"task assigned to `{name}` is never used again — "
                        f"the reference dies with the frame, so the task "
                        f"can be GC'd mid-flight and its exception is "
                        f"never retrieved",
                hint="register a done callback / add to a tracked set, "
                     "or await it before the function returns",
                qualname=module.qualname_at(call.lineno))


def check_task_retention(module: Module, project: Project) -> Iterable[Finding]:
    mf = project.flow(module)
    for flow in mf.functions.values():
        yield from _findings_for_flow(module, flow, mf.imports)
