"""LIF01: lifecycle overrides must chain super.

`LifecycleComponent` runs an explicit state machine: `initialize/start/
stop` validate transitions, recurse into children, and capture errors.
A subclass that overrides one of them WITHOUT chaining super skips the
state machine entirely — children never start, crashes never reach
`state_tree()`/health, and stop() leaks the background task. The
supported extension points are the `_do_initialize/_do_start/_do_stop`
hooks.

Two rules, both resolved through the project-wide class index (so the
check sees `Foo(SupervisedTaskComponent)` is transitively a
BackgroundTaskComponent even across files):

- a (transitive) `LifecycleComponent` subclass overriding `initialize`,
  `start`, `stop`, or `restart` must call `super().<same>()`;
- a (strict) `BackgroundTaskComponent` subclass overriding `_do_stop`
  must call `super()._do_stop(...)` — that super call is what cancels
  the owned task; skipping it leaks the poll loop past stop().
"""

from __future__ import annotations

import ast
from typing import Iterable

from sitewhere_tpu_torch.analysis.engine import Finding, Module, Project

_STATE_MACHINE = {"initialize", "start", "stop", "restart"}
_LIFECYCLE_ROOT = "LifecycleComponent"
_BGTASK_ROOT = "BackgroundTaskComponent"


def _chains_super(fn: ast.AST, method: str) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr == method \
                and isinstance(node.func.value, ast.Call) \
                and isinstance(node.func.value.func, ast.Name) \
                and node.func.value.func.id == "super":
            return True
    return False


def check_lifecycle_super(module: Module, project: Project) -> Iterable[Finding]:
    for cls in ast.walk(module.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        is_lifecycle = project.is_subclass_of(cls.name, _LIFECYCLE_ROOT)
        is_bgtask = project.is_subclass_of(cls.name, _BGTASK_ROOT)
        if not is_lifecycle and not is_bgtask:
            continue
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if is_lifecycle and item.name in _STATE_MACHINE \
                    and not _chains_super(item, item.name):
                yield Finding(
                    path=module.relpath, line=item.lineno, code="LIF01",
                    message=f"`{cls.name}.{item.name}` overrides the "
                            f"lifecycle state machine without chaining "
                            f"`super().{item.name}()` — children and "
                            f"error capture are skipped",
                    hint=f"chain `await super().{item.name}(...)`, or move "
                         f"the logic into the `_do_{item.name}` hook",
                    qualname=module.qualname_at(item.lineno))
            elif is_bgtask and item.name == "_do_stop" \
                    and not _chains_super(item, "_do_stop"):
                yield Finding(
                    path=module.relpath, line=item.lineno, code="LIF01",
                    message=f"`{cls.name}._do_stop` does not chain "
                            f"`super()._do_stop()` — the owned background "
                            f"task is never cancelled and leaks past "
                            f"stop()",
                    hint="start the override with "
                         "`await super()._do_stop(monitor)`",
                    qualname=module.qualname_at(item.lineno))
